"""Fused non-causal attention with an additive key bias (flash attention).

The port of ``skycomputing_tpu/ops/flash_attention.py``.  On CUDA tensors
:func:`flash_attention` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use, bound with ``ctypes``), so the [L, L] score matrix never reaches
device memory.  It has two bodies, and :func:`kernel_plan` picks one
from the dtype and head_dim alone: bfloat16 with a head_dim that is a
multiple of 16 runs the tensor-core body (``mma.sync`` products,
``cp.async`` double-buffered K/V tiles, online softmax in registers);
float32, and bfloat16 with any other head_dim, run the CUDA-core body
(float32 FMAs throughout).  The bias is read in its stored dtype, so a
call launches the kernel and nothing else.  On CPU tensors it runs
:func:`flash_attention_reference`, the plain PyTorch version of the same
function.  Nothing else picks the path: a CUDA call either launches the
kernel or raises.

The gradient is the JAX module's: the forward is the kernel, the
backward recomputes the plain version in float32 under autograd
(``_bwd`` there), so a training step launches the kernel once per
forward and once per rematerialized forward, never in the backward.
``flash_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_BODIES = ("cuda_core", "tensor_core")  # the kernel's body codes 0 and 1
_lib = None
_sm_counts = {}


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("flash_attention")
        # body, warps, dtype; q, k, v, bias; bias dtype; bias strides;
        # out; B, L, H, D; scale; stream
        lib.sky_flash_attention.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.sky_flash_attention.restype = ctypes.c_int
        lib.sky_flash_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.sky_flash_attention_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sm_count(device) -> int:
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def kernel_plan(dtype, B: int, L: int, H: int, D: int,
                sm_count: int) -> dict:
    """Which body of the kernel serves a call, by dtype and head_dim
    alone: ``"tensor_core"`` for bfloat16 with ``D`` a multiple of 16,
    else ``"cuda_core"``.  The tensor-core body gives each warp 16
    queries; ``warps`` is 4 unless fewer blocks than ``sm_count`` would
    result, then 2 or 1 (more, smaller blocks fill the card).  The
    CUDA-core body always takes 32 queries on 4 warps."""
    if dtype == torch.bfloat16 and D % 16 == 0 and D <= _MAX_HEAD_DIM:
        warps = 4
        while warps > 1 and -(-L // (16 * warps)) * H * B < sm_count:
            warps //= 2
        return dict(body="tensor_core", warps=warps, q_tile=16 * warps)
    return dict(body="cuda_core", warps=4, q_tile=32)


def kernel_smem_bytes(plan: dict, D: int) -> int:
    """Dynamic shared memory of one block of ``plan``'s body (builds and
    loads the kernel's library)."""
    return _library().sky_flash_attention_smem(
        _BODIES.index(plan["body"]), D, plan["warps"])


def check_blocks(seq_len: int, block_q: int, block_k: int) -> None:
    """The JAX module's block picker, kept for its refusal: a length
    over 1024 with no multiple-of-8 divisor at most the requested block
    raises ``ValueError`` there (a full-length TPU tile would not fit),
    so it raises here too.  The CUDA kernel tiles any length itself."""
    for requested in (block_q, block_k):
        if seq_len <= requested or seq_len % requested == 0:
            continue
        if any(seq_len % b == 0
               for b in range(requested - requested % 8, 7, -8)):
            continue
        if seq_len > 1024:
            raise ValueError(
                f"seq len {seq_len} has no 8-aligned divisor <= "
                f"{requested}; pad the sequence to a multiple of 128"
            )


def flash_attention_reference(q, k, v, bias, scale: float) -> torch.Tensor:
    """Plain PyTorch version (the JAX module's ``_reference_attention``):
    materialized float32 scores, bias added per key, float32 softmax,
    output in q's dtype.  q/k/v: [B, L, H, D]; bias: [B, L]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s = s + bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _launch(q, k, v, bias, scale: float) -> torch.Tensor:
    """Check what the kernel takes (raising on anything else), launch it
    on the current stream and count the launch."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    B, L, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(
                f"{name} must be {q.dtype} on {q.device}, got {t.dtype} "
                f"on {t.device}"
            )
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernel's {_MAX_HEAD_DIM}")
    if bias.device != q.device or tuple(bias.shape) != (B, L):
        raise ValueError(
            f"bias must be [B={B}, L={L}] on {q.device}, got "
            f"{tuple(bias.shape)} on {bias.device}"
        )
    if bias.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash_attention kernel takes a float32 or bfloat16 bias, got "
            f"{bias.dtype}"
        )
    plan = kernel_plan(q.dtype, B, L, H, D, _sm_count(q.device))
    out = torch.empty_like(q)
    if plan["body"] == "tensor_core" and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("q, k and v must be 16-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the bias is read in its stored dtype at its own strides
        rc = _library().sky_flash_attention(
            _BODIES.index(plan["body"]), plan["warps"],
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), _DTYPE_CODES[bias.dtype], bias.stride(0),
            bias.stride(1), out.data_ptr(), B, L, H, D, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError_t {rc}"
        )
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward = autograd of the float32 plain version
    on the saved inputs (the JAX module's ``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _launch(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, needs)]
            out = flash_attention_reference(*inputs, ctx.scale)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if need else None for need in needs), None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[float] = None,
    block_q: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """Fused attention.  q/k/v: [B, L, H, D]; bias: [B, L] additive mask
    (0 or -1e4 style, in the model dtype).  Returns [B, L, H, D] in q's
    dtype; differentiable in q, k, v and bias.

    ``block_q``/``block_k`` are the JAX signature's TPU tile requests:
    they only decide the ``ValueError`` of :func:`check_blocks`.  CPU
    tensors take :func:`flash_attention_reference`; CUDA tensors launch
    the kernel (float32 or bfloat16, ``D <= 128``, the bias float32 or
    bfloat16; the body from :func:`kernel_plan`) and count it in
    ``flash_attention.launches``; anything the kernel does not take
    raises.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    check_blocks(q.shape[1], block_q, block_k)
    # a meta tensor computes nothing: the plain version gives the static
    # profiler the output's shape and the FLOP counter the products
    if q.device.type in ("cpu", "meta"):
        return flash_attention_reference(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bias, float(scale))


flash_attention.launches = 0

__all__ = ["check_blocks", "flash_attention", "flash_attention_reference",
           "kernel_plan", "kernel_smem_bytes"]
