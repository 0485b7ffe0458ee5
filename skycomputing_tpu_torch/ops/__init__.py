"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``csrc/`` holds the CUDA sources, ``_build`` compiles
them at first use)."""

from .paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)

__all__ = ["paged_attention", "paged_attention_int8",
           "paged_attention_reference"]
