"""Device and dtype helpers shared by the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name) -> torch.dtype:
    """A config dtype string (``"bfloat16"``, ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}"
        ) from None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another.  With no CUDA device and no explicit request this
    raises — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


__all__ = ["resolve_device", "torch_dtype"]
