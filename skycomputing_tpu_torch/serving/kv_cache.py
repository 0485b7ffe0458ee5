"""Paged KV-cache device math: the port of the fp paged half of
``skycomputing_tpu/serving/kv_cache.py``.

Pages are ``[num_pages, page_size, heads, head_dim]`` slabs, one (k, v)
pair per attention layer, shared by every row through per-row page
tables (host bookkeeping in :mod:`.paging`).  The invariants are the
JAX module's:

- **masked staleness**: positions at or beyond a row's current length
  hold stale garbage by design; :func:`decode_visibility` (and the
  kernel's identical rule) masks them, so a freed page is reused with
  no zeroing pass;
- **dropped writes**: pad-tail positions of a bucketed prefill
  (``>= valid_len``) and positions whose table entry is a sentinel
  never touch a page;
- **disjoint writes**: the pool's copy-on-write contract keeps shared
  pages read-only, so the rows' write destinations never overlap and
  scatter order cannot matter.

Unlike JAX's functional ``.at[].set``, the port's writes are IN PLACE on
the slabs it is given (``index_copy_``): the engine owns the slabs and
rebinds nothing.

The int8 ``QuantizedPages`` pool waits for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils import torch_dtype


def decode_positions(index, query_len: int) -> torch.Tensor:
    """Absolute positions [B|1, Lq] of the query tokens (for wpe)."""
    index = torch.as_tensor(index)
    return index.reshape(-1, 1) + torch.arange(
        query_len, dtype=index.dtype, device=index.device
    )


def decode_visibility(index, query_len: int, max_len: int) -> torch.Tensor:
    """Causal visibility mask for incremental decode: [B|1, Lq, max_len].

    Query ``q`` of row ``b`` sits at ``index[b] + q`` and may attend to
    cache positions ``<=`` it; stale garbage beyond a row's length is
    strictly in the future, so this one mask also hides it.
    """
    q_pos = decode_positions(index, query_len)
    k_pos = torch.arange(max_len, dtype=q_pos.dtype, device=q_pos.device)
    return k_pos[None, None, :] <= q_pos[:, :, None]


class PagedWrite(NamedTuple):
    """Where one step's new K/V rows land: ``src`` indexes the flattened
    ``[R * Lq]`` new rows, ``dst`` the flattened ``[num_pages *
    page_size]`` slab positions; dropped writes appear in neither."""

    src: torch.Tensor
    dst: torch.Tensor

    def to(self, device) -> "PagedWrite":
        return PagedWrite(self.src.to(device), self.dst.to(device))


def paged_write_plan(page_table, index, valid_len, num_pages: int,
                     page_size: int, query_len: int) -> PagedWrite:
    """The scatter plan of :func:`paged_update_kv` for new tokens at
    positions ``index .. index + query_len - 1`` of each row.

    Computed on the device ``page_table`` lies on.  The engine builds
    its tables on the host, so the boolean selection here costs no
    device synchronisation; the plan is computed once per step and
    shared by every attention layer (all layers cache the same
    positions).
    """
    table = torch.as_tensor(page_table).long()
    max_pages = table.shape[1]
    index = torch.as_tensor(index, device=table.device).long().reshape(-1, 1)
    valid = torch.as_tensor(valid_len, device=table.device).long()
    R = table.shape[0]
    pos = index + torch.arange(query_len, device=table.device)
    pos = pos.expand(R, query_len)
    logical = pos // page_size
    phys = torch.gather(table, 1, logical.clamp(0, max_pages - 1))
    keep = (
        (pos < valid.reshape(-1, 1))
        & (logical < max_pages)
        & (phys >= 0) & (phys < num_pages)
    ).reshape(-1)
    dst = (phys * page_size + pos % page_size).reshape(-1)
    src = torch.arange(R * query_len, device=table.device)
    return PagedWrite(src[keep], dst[keep])


def scatter_paged_kv(k_slab, v_slab, k_new, v_new, plan: PagedWrite):
    """Write ``k_new``/``v_new`` [R, Lq, heads, head_dim] into the slabs
    IN PLACE along ``plan`` (on the slabs' device); returns the slabs."""
    for slab, new in ((k_slab, k_new), (v_slab, v_new)):
        flat = slab.view((-1,) + tuple(slab.shape[2:]))
        rows = new.reshape((-1,) + tuple(new.shape[2:]))
        flat.index_copy_(0, plan.dst, rows.index_select(0, plan.src)
                         .to(slab.dtype))
    return k_slab, v_slab


def paged_update_kv(k_slab, v_slab, k_new, v_new, page_table, index,
                    valid_len):
    """Scatter ``k_new``/``v_new`` into paged slabs through page tables.

    ``k_slab``/``v_slab``: [num_pages, page_size, heads, head_dim];
    ``k_new``/``v_new``: [R, Lq, heads, head_dim]; ``page_table``:
    [R, max_pages] int32, sentinel-padded (>= num_pages); ``index``:
    [R] start position of each row's new tokens; ``valid_len``: [R]
    true end position — writes at or beyond it are dropped, as are
    writes whose table entry is a sentinel.  Updates the slabs in place
    and returns them.
    """
    plan = paged_write_plan(
        page_table, index, valid_len, k_slab.shape[0], k_slab.shape[1],
        k_new.shape[1],
    ).to(k_slab.device)
    return scatter_paged_kv(k_slab, v_slab, k_new, v_new, plan)


def gather_kv_pages(k_slab, v_slab, page_table):
    """Per-row virtual cache views [R, max_pages * page_size, heads,
    head_dim] through page tables.  Sentinel entries clamp into the slab
    and read garbage that :func:`decode_visibility` masks."""
    num_pages, page_size = k_slab.shape[0], k_slab.shape[1]
    table = torch.as_tensor(page_table, device=k_slab.device).long()
    R = table.shape[0]
    pos = table[:, :, None] * page_size + torch.arange(
        page_size, device=k_slab.device
    )
    pos = pos.reshape(R, -1).clamp(0, num_pages * page_size - 1)

    def gather(slab):
        return slab.reshape((num_pages * page_size,) + tuple(slab.shape[2:]))[
            pos
        ]

    return gather(k_slab), gather(v_slab)


@dataclass(frozen=True)
class KVCacheSpec:
    """Shape/dtype of one attention layer's slab (minus the row axis)."""

    max_len: int
    num_heads: int
    head_dim: int
    dtype: str = "float32"

    def slab_mb(self, slots: int) -> float:
        """Size of the (k, v) slab PAIR in MB."""
        n = float(slots * self.max_len * self.num_heads * self.head_dim)
        itemsize = torch.empty((), dtype=torch_dtype(self.dtype)).element_size()
        return 2.0 * n * itemsize / 1024.0**2


def kv_spec_from_config(config, max_len: int) -> KVCacheSpec:
    """Spec from a GPT-style config (dict or object with the fields)."""
    get = (
        config.get if isinstance(config, dict)
        else lambda k, d=None: getattr(config, k, d)
    )
    heads = int(get("num_attention_heads"))
    hidden = int(get("hidden_size"))
    return KVCacheSpec(
        max_len=int(max_len),
        num_heads=heads,
        head_dim=hidden // heads,
        dtype=str(get("dtype", "float32")),
    )


def init_paged_caches(
    specs: Sequence[KVCacheSpec],
    num_pages: int,
    page_size: int,
    device=None,
    kv_dtype: Optional[str] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed paged (k, v) slab pairs ``[num_pages, page_size, heads,
    head_dim]`` in the model dtype, one per attention layer."""
    if kv_dtype == "int8":
        raise NotImplementedError(
            "int8 paged KV (QuantizedPages) is not ported yet"
        )
    if kv_dtype is not None:
        raise ValueError(
            f"kv_dtype must be None (the model dtype), got {kv_dtype!r}"
        )
    caches = []
    for spec in specs:
        shape = (num_pages, page_size, spec.num_heads, spec.head_dim)
        dtype = torch_dtype(spec.dtype)
        caches.append((
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        ))
    return caches


__all__ = [
    "KVCacheSpec",
    "PagedWrite",
    "decode_positions",
    "decode_visibility",
    "gather_kv_pages",
    "init_paged_caches",
    "kv_spec_from_config",
    "paged_update_kv",
    "paged_write_plan",
    "scatter_paged_kv",
]
