"""Causal attention over a paged KV pool, the page walk inside a kernel.

The port of ``skycomputing_tpu/ops/paged_attention.py``, for both of
its pools: pages in the model dtype (the JAX module's
``_paged_kernel``) and int8 pages with per-page-per-head float32 scales
(``_paged_kernel_int8``).  On a CUDA tensor :func:`paged_attention`
launches the hand-written Hopper kernel in ``csrc/paged_attention.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, bound with
``ctypes``); on a CPU tensor it runs :func:`paged_attention_reference`,
the plain PyTorch version of the same function.  Nothing else picks the
path: a CUDA call either launches the kernel or raises.

The kernel never materializes a row's gathered K/V view.  It has three
bodies, and :func:`kernel_plan` picks one from the q and page types,
Lq, head_dim and the page size alone.  Decode and speculative-verify
waves (``Lq <= 16``) run the decode body: one block of eight warps per
(row, head), each warp walking its own 16-position chunks of the row
through a ``cp.async`` double buffer with a private float32 online
softmax, the warps' states merged at the end.  Prefill and
chunked-prefill waves (``Lq > 16``) with bfloat16 q, a head_dim and a
page size that are multiples of 16 run the tensor-core body: one block
of four warps per (row, head, 64 queries), each warp holding 16 queries
as ``mma.sync`` fragments while 64-position K/V tiles
(four pages of 16) are gathered through the table with ``cp.async``, two
tiles in flight while one is consumed; an int8 tile is converted to
bfloat16 in shared memory (exact) and its scales are folded into the
float32 scores and into P.  Every other call with ``Lq > 16`` (float32
prefill and chunk waves; bfloat16 q over pages of 4 or 8, or at another
head_dim) runs the register-tile body: one block of four warps per (row,
head, tile of 32 queries, 16 past head_dim 64) splits the tile's
16-position chunks over its warps as the decode body does, each lane
holding a 4-query x 4-key tile of float32 scores and its 4 queries'
accumulator over 16 head dims in registers, every product a float32
FMA.  The decode and register-tile bodies take any head_dim up to 128
over any page type: a K/V row that is not whole 16-byte slots is staged
padded to whole slots, the padding zero, and copied in the widest
granule its bytes allow (:func:`row_plan`).
``csrc/paged_attention.cu`` says what bounds the kernel on the card and
what each body does about that.

Each pool's kernel counts its own launches: ``paged_attention.launches``
for the fp pool, ``paged_attention_int8.launches`` for the int8 pool,
and, at the same place, each wrapper's ``body_launches[body]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .flash_attention import copy_granule

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_DECODE_Q = 16
_MMA_TILE = 16  # head_dim and page-size granule of the tensor-core body
# the kernel's body codes 0, 1 and 2
_BODIES = ("decode", "tensor_core", "register_tile")
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/paged_attention.cu``; returns ``lib``."""
    # body, dtype; q, k, v, table, index, out; R, Lq, H, D, copy bytes,
    # num_pages, page_size, width; scale; stream
    lib.sky_paged_attention.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    # the same with k_scale, v_scale after v
    lib.sky_paged_attention_int8.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.sky_paged_attention.restype = ctypes.c_int
    lib.sky_paged_attention_int8.restype = ctypes.c_int
    lib.sky_paged_attention_smem.argtypes = [ctypes.c_int] * 5
    lib.sky_paged_attention_smem.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        from . import _build

        _lib = bind(_build.load("paged_attention"))
    return _lib


def kernel_plan(q_dtype, page_dtype, Lq: int, D: int, page_size: int) -> str:
    """Which body of the kernel serves a call, from the q and page
    types, Lq, head_dim and the page size alone, for every head_dim up
    to 128 over every page type:

    - ``"decode"`` where ``Lq <= 16`` (its warps per block are the
      kernel's: 8, or 4 where 8 would not fit in shared memory);
    - ``"tensor_core"`` for the other calls (``Lq > 16``) with bfloat16
      q and ``D`` and ``page_size`` multiples of 16 (4 warps of 16
      queries per block);
    - ``"register_tile"`` for the rest (4 warps per block of 32
      queries, 16 past head_dim 64).

    The decode and register-tile bodies stage each K/V row as
    :func:`row_plan` says; the tensor-core body's rows are always whole
    16-byte chunks."""
    if Lq <= _MAX_DECODE_Q:
        return "decode"
    if (q_dtype == torch.bfloat16 and D % _MMA_TILE == 0
            and D <= _MAX_HEAD_DIM and page_size % _MMA_TILE == 0):
        return "tensor_core"
    return "register_tile"


def row_plan(page_dtype, D: int) -> dict:
    """How the kernel stages a K/V row of ``D`` elements of
    ``page_dtype``: ``padded_dim`` elements wide (the row's bytes
    rounded up to a whole 16-byte slot, the padding zero), copied
    ``copy_bytes`` at a time (:func:`~.flash_attention.copy_granule` of
    the row's bytes; the pages must be aligned to it)."""
    row = D * page_dtype.itemsize
    return dict(padded_dim=-(-row // 16) * 16 // page_dtype.itemsize,
                copy_bytes=copy_granule(row))


def kernel_smem_bytes(body: str, page_dtype, Lq: int, D: int,
                      width: int) -> int:
    """Dynamic shared memory of one block of ``body`` (builds and loads
    the kernel's library)."""
    return _library().sky_paged_attention_smem(
        _BODIES.index(body), page_dtype.itemsize, Lq, D, width)


def _row_index(index, R: int, device) -> torch.Tensor:
    """``index`` (scalar or [R]) as a contiguous int32 [R] tensor."""
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.reshape(-1).expand(R).contiguous()


def _launch_args(q, pages, page_dtype, page_table, index):
    """Check what the kernel takes (raising on anything else) and return
    the common launch arguments: (body, table, index, R, Lq, H, D, copy
    bytes, P, page_size)."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    R, Lq, H, D = q.shape
    P, page_size = pages[0].shape[0], pages[0].shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    for name, t in zip(("k_pages", "v_pages"), pages):
        if t.device != q.device or t.dtype != page_dtype:
            raise ValueError(
                f"{name} must be {page_dtype} on {q.device}, got {t.dtype} "
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
    body = kernel_plan(q.dtype, page_dtype, Lq, D, page_size)
    copy = row_plan(page_dtype, D)["copy_bytes"]
    if any(t.data_ptr() % copy for t in pages):
        raise ValueError(f"k_pages and v_pages must be {copy}-byte aligned")
    if body == "tensor_core" and q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    idx = _row_index(index, R, q.device)
    return body, table, idx, R, Lq, H, D, copy, P, page_size


def _check_rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError_t {rc}"
        )


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    index,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``q`` over the pages its rows' tables name.

    ``q``: [R, Lq, H, D] (``Lq = 1`` decode, ``Lq = k + 1`` speculative
    verify, ``Lq = bucket`` prefill); ``k_pages``/``v_pages``:
    [num_pages, page_size, H, D] in q's dtype — or int8, with
    ``k_scale``/``v_scale`` [num_pages, H] float32 dequant scales (pass
    both or neither); ``page_table``: [R, W] int32, sentinel-padded
    (entries >= num_pages clamp into the pool and are causally masked);
    ``index``: [R] (or a scalar) position of each row's first query —
    query ``j`` sees positions ``<= index + j``.  Returns [R, Lq, H, D]
    in q's dtype.

    CPU tensors take :func:`paged_attention_reference`.  CUDA tensors
    launch the kernel (q float32 or bfloat16, ``D <= 128``; the body
    from :func:`kernel_plan`) and count the launch in
    ``paged_attention.launches`` (fp pages) or
    ``paged_attention_int8.launches`` (int8 pages), and in that
    wrapper's ``body_launches``; anything the kernel does not take
    raises.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass k_scale AND v_scale together (int8) "
                         "or neither (fp)")
    if k_scale is not None:
        return paged_attention_int8(
            q, k_pages, v_pages, k_scale, v_scale, page_table, index,
            softmax_scale=softmax_scale,
        )
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_table, index,
            softmax_scale=softmax_scale,
        )
    body, table, idx, R, Lq, H, D, copy, P, page_size = _launch_args(
        q, (k_pages, v_pages), q.dtype, page_table, index
    )
    if softmax_scale is None:
        softmax_scale = float(D) ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().sky_paged_attention(
            _BODIES.index(body), _DTYPE_CODES[q.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
            idx.data_ptr(), out.data_ptr(), R, Lq, H, D, copy, P, page_size,
            table.shape[1], float(softmax_scale), stream,
        )
    _check_rc(rc)
    paged_attention.launches += 1
    paged_attention.body_launches[body] += 1
    return out


paged_attention.launches = 0
paged_attention.body_launches = dict.fromkeys(_BODIES, 0)


def paged_attention_int8(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    index,
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`paged_attention` over an int8 pool: each page tile is
    dequantized with its (page, head) scale inside the kernel, so no
    dequantized copy of the pool ever exists.  ``k_scale``/``v_scale``
    are contiguous float32 [num_pages, H] on q's device.  CPU tensors
    take the plain version; CUDA tensors launch the kernel and count it
    in ``paged_attention_int8.launches``."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_table, index, k_scale=k_scale,
            v_scale=v_scale, softmax_scale=softmax_scale,
        )
    body, table, idx, R, Lq, H, D, copy, P, page_size = _launch_args(
        q, (k_pages, v_pages), torch.int8, page_table, index
    )
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.device != q.device or s.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 on {q.device}, got {s.dtype} "
                f"on {s.device}"
            )
        if tuple(s.shape) != (P, H):
            raise ValueError(f"{name} shape {tuple(s.shape)} != {(P, H)}")
        if not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if softmax_scale is None:
        softmax_scale = float(D) ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().sky_paged_attention_int8(
            _BODIES.index(body), _DTYPE_CODES[q.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), R, Lq, H, D, copy, P, page_size, table.shape[1],
            float(softmax_scale), stream,
        )
    _check_rc(rc)
    paged_attention_int8.launches += 1
    paged_attention_int8.body_launches[body] += 1
    return out


paged_attention_int8.launches = 0
paged_attention_int8.body_launches = dict.fromkeys(_BODIES, 0)


def paged_attention_reference(
    q, k_pages, v_pages, page_table, index, *,
    k_scale=None, v_scale=None, softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's exact contract: gather
    each row's virtual K/V view (materialized — the cost the kernel
    removes), dequantized in float32 when scales are given, mask by
    logical position, float32 softmax.

    A sentinel entry reads page ``num_pages - 1``, as in the kernel and
    the JAX package's Pallas kernel.  (The JAX XLA reference clips the
    flat position instead, so the two disagree where a sentinel lies
    inside a row's visible span: only on pad and inactive rows, whose
    output is discarded.)"""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass k_scale AND v_scale together (int8) "
                         "or neither (fp)")
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

    def gather(pages, scale):
        virt = pages.reshape(P * page_size, H, D)[flat_pos].float()
        if scale is not None:
            virt = virt * scale[flat_pos // page_size][:, :, :, None]
        return virt

    k_virt = gather(k_pages, k_scale)
    v_virt = gather(v_pages, v_scale)
    s = torch.einsum("blhd,bmhd->bhlm", q.float() * softmax_scale, k_virt)
    qpos = idx[:, None] + torch.arange(Lq, device=device)
    kpos = torch.arange(k_virt.shape[1], device=device)
    visible = kpos[None, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~visible[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v_virt).to(q.dtype)


__all__ = ["bind", "kernel_plan", "kernel_smem_bytes", "paged_attention",
           "paged_attention_int8", "paged_attention_reference", "row_plan"]
