"""Causal attention over a paged KV pool, the page walk inside a kernel.

The port of ``skycomputing_tpu/ops/paged_attention.py``'s fp path.  On a
CUDA tensor :func:`paged_attention` launches the hand-written Hopper
kernel in ``csrc/paged_attention.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound with ``ctypes``); on a CPU tensor it runs
:func:`paged_attention_reference`, the plain PyTorch version of the same
function.  Nothing else picks the path: a CUDA call either launches the
kernel or raises.

The kernel never materializes a row's gathered K/V view: one thread
block per (row, head, tile of 16 queries) walks the row's page table in
order, staging each page's K/V tile through shared memory and folding it
into a float32 online softmax.  ``csrc/paged_attention.cu`` says what
bounds it on the card and what its design does about that.

int8 pages (``k_scale``/``v_scale``, the JAX module's
``_paged_kernel_int8``) are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("paged_attention")
        fn = lib.sky_paged_attention
        # dtype; q, k, v, table, index, out; R, Lq, H, D, num_pages,
        # page_size, width; scale; stream
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _row_index(index, R: int, device) -> torch.Tensor:
    """``index`` (scalar or [R]) as a contiguous int32 [R] tensor."""
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.reshape(-1).expand(R).contiguous()


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    index,
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``q`` over the pages its rows' tables name.

    ``q``: [R, Lq, H, D] (``Lq = 1`` decode, ``Lq = bucket`` prefill);
    ``k_pages``/``v_pages``: [num_pages, page_size, H, D] in q's dtype;
    ``page_table``: [R, W] int32, sentinel-padded (entries >= num_pages
    clamp into the pool and are causally masked); ``index``: [R] (or a
    scalar) position of each row's first query — query ``j`` sees
    positions ``<= index + j``.  Returns [R, Lq, H, D] in q's dtype.

    CPU tensors take :func:`paged_attention_reference`.  CUDA tensors
    launch the kernel (float32 or bfloat16, ``D <= 128``) and count the
    launch in ``paged_attention.launches``; anything the kernel does not
    take raises.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_table, index,
            softmax_scale=softmax_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    R, Lq, H, D = q.shape
    P, page_size = k_pages.shape[0], k_pages.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(
                f"{name} must be {q.dtype} on {q.device}, got {t.dtype} "
                f"on {t.device}"
            )
        if tuple(t.shape) != (P, page_size, H, D):
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != {(P, page_size, H, D)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernel's {_MAX_HEAD_DIM}")
    if (page_table.dim() != 2 or page_table.shape[0] != R
            or page_table.shape[1] < 1):
        raise ValueError(
            f"page_table must be [R={R}, W>=1], got {tuple(page_table.shape)}"
        )
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    idx = _row_index(index, R, q.device)
    if softmax_scale is None:
        softmax_scale = float(D) ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().sky_paged_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), R, Lq, H, D, P, page_size, table.shape[1],
            float(softmax_scale), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError_t {rc}"
        )
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_reference(
    q, k_pages, v_pages, page_table, index, *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's exact contract: gather
    each row's virtual K/V view (materialized — the cost the kernel
    removes), mask by logical position, float32 softmax.

    A sentinel entry reads page ``num_pages - 1``, as in the kernel and
    the JAX package's Pallas kernel.  (The JAX XLA reference clips the
    flat position instead, so the two disagree where a sentinel lies
    inside a row's visible span: only on pad and inactive rows, whose
    output is discarded.)"""
    R, Lq, H, D = q.shape
    P, page_size = k_pages.shape[0], k_pages.shape[1]
    if softmax_scale is None:
        softmax_scale = float(D) ** -0.5
    device = q.device
    idx = _row_index(index, R, device).long()
    table = torch.as_tensor(page_table, device=device).long().clamp(0, P - 1)
    pos = table[:, :, None] * page_size + torch.arange(
        page_size, device=device
    )
    flat_pos = pos.reshape(R, -1)
    k_virt = k_pages.reshape(P * page_size, H, D)[flat_pos].float()
    v_virt = v_pages.reshape(P * page_size, H, D)[flat_pos].float()
    s = torch.einsum("blhd,bmhd->bhlm", q.float() * softmax_scale, k_virt)
    qpos = idx[:, None] + torch.arange(Lq, device=device)
    kpos = torch.arange(k_virt.shape[1], device=device)
    visible = kpos[None, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~visible[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v_virt).to(q.dtype)


__all__ = ["paged_attention", "paged_attention_reference"]
