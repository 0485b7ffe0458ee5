"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``csrc/`` holds the CUDA sources, ``_build`` compiles
them at first use), the training losses and the evaluation metrics."""

from .flash_attention import flash_attention, flash_attention_reference
from .losses import build_loss, causal_lm_loss, cross_entropy_loss, mse_loss
from .metrics import (
    accuracy,
    compute_task_metrics,
    f1_score,
    matthews_corrcoef,
)
from .paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)

__all__ = ["accuracy", "build_loss", "causal_lm_loss", "compute_task_metrics",
           "cross_entropy_loss", "f1_score", "flash_attention",
           "flash_attention_reference", "matthews_corrcoef", "mse_loss",
           "paged_attention", "paged_attention_int8",
           "paged_attention_reference"]
