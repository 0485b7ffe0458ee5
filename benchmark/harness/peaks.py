"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

H100_SXM = {
    "bf16_flops": 989e12,
    "tf32_flops": 494.7e12,
    "fp32_flops": 66.9e12,
    "hbm_bytes_per_s": 3.35e12,
}

#: ``torch.cuda.get_device_name()`` -> peaks
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(kind: str) -> dict:
    """The peaks of the card called ``kind``; the H100 SXM's for a card
    this table does not know (the result's ``device.kind`` says which
    card it was)."""
    return PEAKS.get(kind, H100_SXM)


def least_time(flops: float, nbytes: float, peaks: dict,
               flops_key: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peaks[flops_key], nbytes / peaks["hbm_bytes_per_s"])
