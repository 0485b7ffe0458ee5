"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``csrc/`` holds the CUDA sources, ``_build`` compiles
them at first use), and the training losses."""

from .flash_attention import flash_attention, flash_attention_reference
from .losses import build_loss, causal_lm_loss, cross_entropy_loss, mse_loss
from .paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)

__all__ = ["build_loss", "causal_lm_loss", "cross_entropy_loss",
           "flash_attention", "flash_attention_reference", "mse_loss",
           "paged_attention", "paged_attention_int8",
           "paged_attention_reference"]
