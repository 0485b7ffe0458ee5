"""Fused non-causal attention with an additive key bias (flash attention).

The port of ``skycomputing_tpu/ops/flash_attention.py``.  On CUDA tensors
:func:`flash_attention` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use, bound with ``ctypes``), so the [L, L] score matrix never reaches
device memory.  It has two bodies, and :func:`kernel_plan` picks one
from the dtype: bfloat16 runs the tensor-core body (``mma.sync``
products, ``cp.async`` double-buffered K/V tiles, online softmax in
registers); float32 runs the float32 tensor-core body, the same design
on tf32 ``mma.sync`` with each product taken as three (3xTF32,
float32's accuracy).  Each takes every head_dim up to 128: a row is
staged in shared memory at the head_dim rounded up to the mma's k-step
(16 bf16 values, 8 tf32), its pad columns zero, and copied in the
widest granule its bytes allow (the plan's ``padded_dim`` and
``copy_bytes``).  The bias is read in its stored dtype, so a
call launches the kernel and nothing else.  On CPU tensors it runs
:func:`flash_attention_reference`, the plain PyTorch version of the same
function.  Nothing else picks the path: a CUDA call either launches the
kernel or raises.

The gradient is the JAX module's: the forward is the kernel, the
backward recomputes the plain version in float32 under autograd
(``_bwd`` there), so a training step launches the kernel once per
forward and once per rematerialized forward, never in the backward.
``flash_attention.launches`` counts the kernel's launches, and
``flash_attention.body_launches[body]`` each body's.  A call on
``meta`` computes nothing and counts, for the static profiler, the work
XLA's cost analysis charges the JAX kernel on the CPU: one grid cell.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
# the kernel's body codes 0 and 1, and each body's mma k-step in head dims
_BODIES = ("tensor_core", "tensor_core_f32")
_K_STEP = {torch.bfloat16: 16, torch.float32: 8}
_lib = None
_sm_counts = {}


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("flash_attention")
        # body, warps, dtype; q, k, v, bias; bias dtype; bias strides;
        # out; B, L, H, D, copy bytes; scale; stream
        lib.sky_flash_attention.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
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


def copy_granule(row_bytes: int) -> int:
    """The widest copy every row of ``row_bytes`` bytes allows, each row
    starting at a multiple of ``row_bytes`` from a 16-byte aligned base:
    16, 8 or 4 bytes (``cp.async``), else 2 or 1 (an ordinary load);
    ``csrc/common.cuh:copy_granule``, which the kernels check it
    against."""
    granule = 16
    while row_bytes % granule:
        granule //= 2
    return granule


def kernel_plan(dtype, B: int, L: int, H: int, D: int,
                sm_count: int) -> dict:
    """Which body of the kernel serves a call, by dtype alone, for every
    head_dim ``D`` from 1 to 128: ``"tensor_core"`` for bfloat16,
    ``"tensor_core_f32"`` (3xTF32) for float32.  Each stages a row at
    ``padded_dim`` head dims, ``D`` rounded up to its mma's k-step (16
    bf16 values, 8 tf32), the pad columns zero, and copies it
    ``copy_bytes`` at a time (:func:`copy_granule` of the row's bytes).
    Each warp takes 16 queries; ``warps`` is 4 unless fewer blocks than
    ``sm_count`` would result, then 2 or 1 (more, smaller blocks fill
    the card)."""
    if dtype not in _K_STEP:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if not 1 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside the kernel's 1..{_MAX_HEAD_DIM}")
    warps = 4
    while warps > 1 and -(-L // (16 * warps)) * H * B < sm_count:
        warps //= 2
    step = _K_STEP[dtype]
    body = "tensor_core" if dtype == torch.bfloat16 else "tensor_core_f32"
    return dict(body=body, warps=warps,
                q_tile=16 * warps, padded_dim=-(-D // step) * step,
                copy_bytes=copy_granule(D * dtype.itemsize))


def kernel_smem_bytes(plan: dict, D: int) -> int:
    """Dynamic shared memory of one block of ``plan``'s body (builds and
    loads the kernel's library)."""
    return _library().sky_flash_attention_smem(
        _BODIES.index(plan["body"]), D, plan["warps"])


def pick_block(seq_len: int, requested: int) -> int:
    """The JAX module's TPU tile along the sequence for a ``requested``
    block: the request where it tiles ``seq_len`` (or covers it), else
    the largest multiple-of-8 divisor at most the request, else one
    full-length block; a length over 1024 with no such divisor raises
    ``ValueError`` there (a full-length TPU tile would not fit), so it
    raises here too.  The CUDA kernel tiles any length itself; the
    block decides the refusal and the static profile's charge."""
    if seq_len <= requested:
        return seq_len
    if seq_len % requested == 0:
        return requested
    for b in range(requested - requested % 8, 7, -8):
        if seq_len % b == 0:
            return b
    if seq_len > 1024:
        raise ValueError(
            f"seq len {seq_len} has no 8-aligned divisor <= "
            f"{requested}; pad the sequence to a multiple of 128"
        )
    return seq_len


def flash_attention_reference(q, k, v, bias, scale: float,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version (the JAX module's ``_reference_attention``):
    materialized float32 scores, bias added per key, float32 softmax,
    output in q's dtype.  q/k/v: [B, L, H, D]; bias: [B, L].
    ``compute_dtype=torch.float64`` evaluates the same function in float64
    (the card's checks, where float32's own rounding is the question: in
    a row whose every key carries -1e4 the float32 scores round to a step
    of 2^-10, which moves the output by up to about 4e-4)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(compute_dtype) * scale,
                     k.to(compute_dtype))
    s = s + bias[:, None, None, :].to(compute_dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(compute_dtype)).to(q.dtype)


# bf16 outputs against the plain version at long L: the largest error over
# the largest |ref| (about four bf16 ulps of the largest output) and the
# error's RMS over ref's RMS (the kernel's rounding alone gives about
# 2.5e-3; a fault in one key tile of 64 at L=4,096 gives 1.1e-2 or more)
BF16_LONG_TOL = {"max_rel_err": 1.5e-2, "rms_rel_err": 5e-3}


def agreement(out, ref) -> dict:
    """How far ``out`` lies from ``ref``, scaled to what is compared: the
    largest absolute error, that error over the largest ``|ref|``, and
    the error's RMS over ``ref``'s RMS.  At long L each output averages
    about L/e keys and shrinks (RMS 0.027 at L=4,096 with q/k/v ~ N(0,
    1)), so an absolute bf16 tolerance set at L=128 would pass a fault in
    a key tile; :data:`BF16_LONG_TOL` bounds the two ratios."""
    err, ref = out.float() - ref.float(), ref.float()
    worst = err.abs().max().item()
    return {"max_abs_err": worst,
            "max_rel_err": worst / ref.abs().max().item(),
            "rms_rel_err": (err.square().mean().sqrt()
                            / ref.square().mean().sqrt()).item()}


class _MetaFlashAttention(torch.autograd.Function):
    """A call on ``meta`` (the static profiler, the pre-flight): the
    output's shape, gradients of the inputs' shapes, and the plain
    version run over one grid cell of the JAX kernel (one row and head,
    ``block_q`` queries, one key block of ``block_k``) so that a FLOP
    counter charges what XLA's cost analysis charges the JAX package's
    kernel on the CPU, where it runs in interpret mode: a loop over the
    grid whose body, with the key-block loop inside it, is counted
    once."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, block_q, block_k):
        ctx.shapes = [t.shape for t in (q, k, v, bias)]
        cell = (slice(0, 1), slice(0, block_q), slice(0, 1))
        keys = (slice(0, 1), slice(0, block_k), slice(0, 1))
        flash_attention_reference(q[cell], k[keys], v[keys],
                                  bias[:1, :block_k], scale)
        return q.new_empty(q.shape)

    @staticmethod
    def backward(ctx, grad_out):
        return (*(grad_out.new_empty(shape) if need else None
                  for shape, need in zip(ctx.shapes, ctx.needs_input_grad)),
                None, None, None)


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
    if any(t.data_ptr() % plan["copy_bytes"] for t in (q, k, v, out)):
        raise ValueError(
            f"q, k and v must be {plan['copy_bytes']}-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the bias is read in its stored dtype at its own strides
        rc = _library().sky_flash_attention(
            _BODIES.index(plan["body"]), plan["warps"],
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), _DTYPE_CODES[bias.dtype], bias.stride(0),
            bias.stride(1), out.data_ptr(), B, L, H, D, plan["copy_bytes"],
            float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError_t {rc}"
        )
    flash_attention.launches += 1
    flash_attention.body_launches[plan["body"]] += 1
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
    they decide the ``ValueError`` of :func:`pick_block` and, on
    ``meta``, the one grid cell whose work is counted
    (:class:`_MetaFlashAttention`).  CPU tensors take
    :func:`flash_attention_reference`; CUDA tensors launch
    the kernel (float32 or bfloat16, ``D <= 128``, the bias float32 or
    bfloat16; the body from :func:`kernel_plan`) and count it in
    ``flash_attention.launches`` and ``flash_attention.body_launches``;
    anything the kernel does not take raises.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    L = q.shape[1]
    bq, bk = pick_block(L, block_q), pick_block(L, block_k)
    if q.device.type == "meta":
        return _MetaFlashAttention.apply(q, k, v, bias, float(scale), bq, bk)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bias, float(scale))


flash_attention.launches = 0
flash_attention.body_launches = dict.fromkeys(_BODIES, 0)

__all__ = ["BF16_LONG_TOL", "agreement", "copy_granule", "flash_attention",
           "flash_attention_reference", "kernel_plan", "kernel_smem_bytes",
           "pick_block"]
