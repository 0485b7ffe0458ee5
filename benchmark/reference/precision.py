"""Float32 without TF32, and the fp8 rounding of the control."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """Products in full float32: TF32 off for matmuls and cuDNN, restored
    on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale that maps the
    tensor's largest magnitude to e4m3's largest value (448), as fp8
    training and serving scale; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = 448.0 / amax
        return ((x.float() * scale).to(torch.float8_e4m3fn).float()
                / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


QUANTIZERS = {"fp8": fp8}


def quantizer(name):
    """The operand rounding called ``name`` (None: none)."""
    if name is None:
        return lambda x: x
    return QUANTIZERS[name]
