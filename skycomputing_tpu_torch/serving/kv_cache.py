"""KV-cache device math: the port of
``skycomputing_tpu/serving/kv_cache.py``.  Slot slabs ``[slots, max_len,
heads, head_dim]`` (:func:`init_layer_caches`, :class:`SlotKVCachePool`,
the write :func:`update_kv_cache`) back the serving engine's slot
layout, the single-request decoder and the decode profile; paged pools
serve in the model dtype and as int8 (:class:`QuantizedPages`); the KV
memory formulas are what the allocator and the pre-flight verifier
charge (:func:`kv_mb_per_layer`, :func:`paged_kv_mb_per_layer`).

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
rebinds nothing.  That holds for an int8 pool too: its values and its
scale slab are written in place, so a :class:`QuantizedPages` tuple
never goes stale.

A step's writes are planned once on the host (:func:`write_plan`: a
:class:`PagedWrite` for an fp pool, a :class:`QuantizedWrite` for an
int8 pool) and applied to every attention layer's slabs
(:func:`scatter_kv`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..utils import torch_dtype


def update_kv_cache(k_cache, v_cache, k_new, v_new, index):
    """Write ``k_new``/``v_new`` [B, Lq, heads, head_dim] into SLOT slabs
    ``k_cache``/``v_cache`` [B, max_len, heads, head_dim] at per-row
    positions, in place; returns the caches.

    ``index`` is a scalar (every row writes at one offset) or a [B]
    vector (each row at its own).  A start past ``max_len - Lq`` clamps
    to it, as ``jax.lax.dynamic_update_slice`` clamps in the reference,
    so an inactive row never writes outside itself.  The slot layout's
    decode step (``GptBlock_Attn.decode``) and the decode profile
    (:class:`~.profile.DecodeModelBenchmarker`) write through it.
    """
    B, Lq = k_new.shape[0], k_new.shape[1]
    max_len = k_cache.shape[1]
    start = torch.as_tensor(index, device=k_cache.device).long()
    start = start.reshape(-1).expand(B).clamp(0, max_len - Lq)
    pos = start[:, None] + torch.arange(Lq, device=k_cache.device)
    pos = pos[:, :, None, None].expand(k_new.shape)
    k_cache.scatter_(1, pos, k_new.to(k_cache.dtype))
    v_cache.scatter_(1, pos, v_new.to(v_cache.dtype))
    return k_cache, v_cache


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


class QuantizedPages(NamedTuple):
    """An int8 page slab with its per-page-per-head dequant scales.

    ``values``: [num_pages, page_size, heads, head_dim] int8;
    ``scale``: [num_pages, heads] float32, the parallel *scale slab*.
    One symmetric amax scale covers a (page, head) tile: the dequantized
    value is ``values * scale``.  Every paged-math entry point here
    dispatches on this type, so ``kv_dtype="int8"`` changes no caller
    signatures.  Both tensors are written in place.
    """

    values: torch.Tensor
    scale: torch.Tensor


def quantize_pages(values, scale_hint=None):
    """Symmetric per-page-per-head int8 quantization of a page-shaped fp
    tensor [..., page_size, heads, head_dim] -> (int8, scale [...,
    heads]).  ``scale_hint`` (the scale's shape) floors the scale: pages
    re-quantized on append keep a monotone scale, so already-stored
    tokens never lose range.  An all-zero tile takes scale 1."""
    values = values.float()
    scale = values.abs().amax(dim=(-3, -1)) / 127.0
    if scale_hint is not None:
        scale = torch.maximum(scale, scale_hint)
    safe = scale.clamp_min(1e-12)
    q = torch.round(values / safe[..., None, :, None]).clamp(-127, 127)
    return q.to(torch.int8), torch.where(
        scale > 0, scale, torch.ones_like(scale)
    )


class PageRequant(NamedTuple):
    """One of the pages a step's rows straddle, for the rows that write
    a real page there: ``rows`` [n] index the step's new tokens,
    ``phys`` [n] the pages; per page position, ``offset`` [n, page_size]
    is the (clipped) new token it would take, ``write_here`` whether it
    does, ``live`` whether it lies below ``valid_len`` (positions past
    it are zeroed); ``has_old`` [n, 1] says whether the page held live
    data before this write (else the scale slab's entry is stale and
    the page takes a fresh scale)."""

    rows: torch.Tensor
    phys: torch.Tensor
    offset: torch.Tensor
    write_here: torch.Tensor
    live: torch.Tensor
    has_old: torch.Tensor


class QuantizedWrite(NamedTuple):
    """The int8 write of one step: the pages each row's span can
    straddle, in order (``(Lq - 1) // page_size + 2`` at most); each
    entry is re-quantized against the slab as the previous ones left
    it."""

    pages: Tuple[PageRequant, ...]

    def to(self, device) -> "QuantizedWrite":
        return QuantizedWrite(tuple(
            PageRequant(*(t.to(device) for t in p)) for p in self.pages
        ))


def quantized_write_plan(page_table, index, valid_len, num_pages: int,
                         page_size: int, query_len: int) -> QuantizedWrite:
    """The plan of the JAX package's ``_paged_update_kv_int8`` for new
    tokens at positions ``index .. index + query_len - 1``: page ``j``
    of a row's span is logical page ``index // page_size + j``, written
    where it lies inside the span, below ``valid_len`` and inside the
    table, and maps to a real page.  Rows that write nothing at page
    ``j`` are left out of that entry (JAX drops their scatter)."""
    table = torch.as_tensor(page_table).long()
    R, max_pages = table.shape
    index = torch.as_tensor(index, device=table.device).long()
    index = index.reshape(-1).expand(R)
    valid = torch.as_tensor(valid_len, device=table.device).long()
    valid = valid.reshape(-1).expand(R)
    ar = torch.arange(page_size, device=table.device)
    last_page = (index + query_len - 1) // page_size
    pages = []
    for j in range((query_len - 1) // page_size + 2):
        lp = index // page_size + j
        phys = torch.gather(table, 1, lp.clamp(0, max_pages - 1)[:, None])
        phys = phys[:, 0]
        real = ((lp <= last_page) & (lp * page_size < valid)
                & (lp < max_pages) & (phys >= 0) & (phys < num_pages))
        rows = real.nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        lp, idx, val = lp[rows], index[rows], valid[rows]
        gpos = lp[:, None] * page_size + ar  # positions of the page
        offset = gpos - idx[:, None]
        pages.append(PageRequant(
            rows=rows, phys=phys[rows],
            offset=offset.clamp(0, query_len - 1),
            write_here=((offset >= 0) & (offset < query_len)
                        & (gpos < val[:, None])),
            live=gpos < val[:, None],
            has_old=(lp * page_size < idx)[:, None],
        ))
    return QuantizedWrite(tuple(pages))


def scatter_quantized_kv(k_slab: QuantizedPages, v_slab: QuantizedPages,
                         k_new, v_new, plan: QuantizedWrite):
    """Quantize-on-write, IN PLACE: for each page of ``plan`` in order,
    gather and dequantize the old page, merge in the new positions,
    zero the positions at or past ``valid_len``, and re-quantize with
    the scale floored at the page's old scale (a page whose live data
    starts at this write takes a fresh scale); values and scales are
    written back with ``index_copy_``.  Returns the slabs."""
    for slab, new in ((k_slab, k_new), (v_slab, v_new)):
        new = new.float()
        for w in plan.pages:
            old_s = slab.scale[w.phys]  # [n, H]
            old_f = slab.values[w.phys].float() * old_s[:, None, :, None]
            picked = new[w.rows[:, None], w.offset]  # [n, ps, H, D]
            merged = torch.where(w.write_here[..., None, None], picked,
                                 old_f)
            merged = torch.where(w.live[..., None, None], merged, 0.0)
            q, s = quantize_pages(
                merged, scale_hint=torch.where(w.has_old, old_s, 0.0)
            )
            slab.values.index_copy_(0, w.phys, q)
            slab.scale.index_copy_(0, w.phys, s)
    return k_slab, v_slab


KVWrite = Union[PagedWrite, QuantizedWrite]


def write_plan(k_slab, page_table, index, valid_len,
               query_len: int) -> KVWrite:
    """The step's write plan for slabs like ``k_slab`` (fp or
    :class:`QuantizedPages`), computed where ``page_table`` lies.  The
    engine builds its tables on the host, so planning costs no device
    synchronisation; one plan serves every attention layer."""
    if isinstance(k_slab, QuantizedPages):
        P, page_size = k_slab.values.shape[0], k_slab.values.shape[1]
        return quantized_write_plan(page_table, index, valid_len, P,
                                    page_size, query_len)
    return paged_write_plan(page_table, index, valid_len, k_slab.shape[0],
                            k_slab.shape[1], query_len)


def scatter_kv(k_slab, v_slab, k_new, v_new, plan: KVWrite):
    """Apply a :func:`write_plan` to one layer's slabs, in place."""
    if isinstance(plan, QuantizedWrite):
        return scatter_quantized_kv(k_slab, v_slab, k_new, v_new, plan)
    return scatter_paged_kv(k_slab, v_slab, k_new, v_new, plan)


def slab_device(slab) -> torch.device:
    """The device a slab (plain or :class:`QuantizedPages`) lives on."""
    return (slab.values if isinstance(slab, QuantizedPages)
            else slab).device


def paged_update_kv(k_slab, v_slab, k_new, v_new, page_table, index,
                    valid_len):
    """Scatter ``k_new``/``v_new`` into paged slabs through page tables.

    ``k_slab``/``v_slab``: [num_pages, page_size, heads, head_dim], or
    :class:`QuantizedPages` (then the writes quantize at write time, see
    :func:`scatter_quantized_kv`); ``k_new``/``v_new``: [R, Lq, heads,
    head_dim]; ``page_table``: [R, max_pages] int32, sentinel-padded (>=
    num_pages); ``index``: [R] start position of each row's new tokens;
    ``valid_len``: [R] true end position — writes at or beyond it are
    dropped, as are writes whose table entry is a sentinel.  Updates the
    slabs in place and returns them.
    """
    plan = write_plan(k_slab, page_table, index, valid_len,
                      k_new.shape[1]).to(slab_device(k_slab))
    return scatter_kv(k_slab, v_slab, k_new, v_new, plan)


def gather_kv_pages(k_slab, v_slab, page_table):
    """Per-row virtual cache views [R, max_pages * page_size, heads,
    head_dim] through page tables.  Sentinel entries clamp into the slab
    and read garbage that :func:`decode_visibility` masks.
    :class:`QuantizedPages` slabs dequantize during the gather (int8
    value x its page's per-head scale) into float32 views."""
    vals = k_slab.values if isinstance(k_slab, QuantizedPages) else k_slab
    num_pages, page_size = vals.shape[0], vals.shape[1]
    table = torch.as_tensor(page_table, device=vals.device).long()
    R = table.shape[0]
    pos = table[:, :, None] * page_size + torch.arange(
        page_size, device=vals.device
    )
    pos = pos.reshape(R, -1).clamp(0, num_pages * page_size - 1)

    def gather(slab):
        if isinstance(slab, QuantizedPages):
            flat = slab.values.reshape(
                (num_pages * page_size,) + tuple(slab.values.shape[2:]))
            return (flat[pos].float()
                    * slab.scale[pos // page_size][:, :, :, None])
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

    def slab_shape(self, slots: int) -> Tuple[int, int, int, int]:
        """One slot slab's shape ``[slots, max_len, heads, head_dim]``."""
        return (slots, self.max_len, self.num_heads, self.head_dim)

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


def init_layer_caches(specs: Sequence[KVCacheSpec], slots: int,
                      device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed slot (k, v) slab pairs ``[slots, max_len, heads,
    head_dim]`` in the model dtype, one per attention layer, on
    ``device``: the one allocation site of the single-request decoder
    and the slot pool."""
    caches = []
    for spec in specs:
        shape = spec.slab_shape(slots)
        dtype = torch_dtype(spec.dtype)
        caches.append((torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device)))
    return caches


class SlotKVCachePool:
    """One stage's slot slabs plus a host-side free-slot allocator.

    The slabs live on the stage's device (allocated once, written in
    place); slot bookkeeping is host state.  A slot id addresses the
    same row of every slab pair of the stage.  :meth:`allocate` returns
    None when no slot is free: exhaustion queues, it never raises.
    """

    def __init__(self, specs: Sequence[KVCacheSpec], slots: int,
                 device=None):
        if slots < 1:
            raise ValueError(f"need at least 1 slot, got {slots}")
        self.specs = list(specs)
        self.num_slots = int(slots)
        self.device = device
        self.slabs = init_layer_caches(self.specs, self.num_slots, device)
        # LIFO free list, as the reference's: the hottest row is reused
        self._free: List[int] = list(range(self.num_slots))[::-1]

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_slots / self.num_slots

    def allocate(self) -> Optional[int]:
        """One free slot id, or None when the pool is exhausted."""
        if not self._free:
            return None
        return self._free.pop()

    def acquire(self, slot: int) -> None:
        """Claim a SPECIFIC free slot: a multi-stage engine allocates an
        id on stage 0 and acquires the same row on every other stage."""
        if slot not in self._free:
            raise ValueError(f"slot {slot} is not free")
        self._free.remove(slot)

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"slot {slot} out of range [0, {self.num_slots})"
            )
        if slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        # no zeroing: stale rows are masked by decode_visibility and
        # overwritten (prefix [:bucket]) by the next prefill
        self._free.append(slot)

    def total_mb(self) -> float:
        """Preallocated slab memory of this pool in MB (all layers)."""
        return float(sum(spec.slab_mb(self.num_slots)
                         for spec in self.specs))


def init_paged_caches(
    specs: Sequence[KVCacheSpec],
    num_pages: int,
    page_size: int,
    device=None,
    kv_dtype: Optional[str] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed paged (k, v) slab pairs ``[num_pages, page_size, heads,
    head_dim]`` in the model dtype, one per attention layer.

    ``kv_dtype="int8"`` allocates :class:`QuantizedPages` pairs instead:
    int8 value slabs plus float32 ``[num_pages, heads]`` scale slabs (a
    zero scale dequantizes to zero, so no zeroing pass is ever owed).
    """
    if kv_dtype not in (None, "int8"):
        raise ValueError(
            f"kv_dtype must be 'int8' or None (the model dtype), "
            f"got {kv_dtype!r}"
        )
    caches = []
    for spec in specs:
        shape = (num_pages, page_size, spec.num_heads, spec.head_dim)
        if kv_dtype == "int8":
            def one():
                return QuantizedPages(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros((num_pages, spec.num_heads),
                                dtype=torch.float32, device=device),
                )
        else:
            def one():
                return torch.zeros(shape, dtype=torch_dtype(spec.dtype),
                                   device=device)
        caches.append((one(), one()))
    return caches


def paged_kv_mb_per_layer(
    model_cfg: Sequence[dict],
    num_pages: int,
    page_size: int,
    attn_layer_type: str = "GptBlock_Attn",
    kv_dtype: Optional[str] = None,
) -> List[float]:
    """Per-layer paged-pool MB for a layer-config list, the paged twin of
    :func:`kv_mb_per_layer`: 0.0 for a unit without a cache, the (k, v)
    pool pair for an attention unit.  ``kv_dtype=None`` charges the
    model dtype (:meth:`KVCacheSpec.slab_mb` at ``num_pages`` rows of
    ``page_size``); an explicit ``kv_dtype`` charges through
    ``paging.paged_pool_mb``, the one formula the allocator, the profile
    and the pre-flight verifier share (int8 values plus the float32
    scale slabs).  Equal to the reference's to the last digit."""
    from .paging import paged_pool_mb

    out: List[float] = []
    for cfg in model_cfg:
        if cfg.get("layer_type") == attn_layer_type:
            spec = kv_spec_from_config(cfg.get("config", {}), page_size)
            if kv_dtype is None:
                out.append(spec.slab_mb(num_pages))
            else:
                out.append(paged_pool_mb(
                    num_pages, page_size, spec.num_heads,
                    spec.head_dim, kv_dtype=kv_dtype,
                ))
        else:
            out.append(0.0)
    return out


def kv_mb_per_layer(
    model_cfg: Sequence[dict],
    slots: int,
    max_len: int,
    attn_layer_type: str = "GptBlock_Attn",
) -> List[float]:
    """Per-layer KV-slab MB of the SLOT layout for a layer-config list:
    0.0 for a unit without a cache, the (k, v) slab pair at ``slots`` x
    ``max_len`` for an attention unit — the memory the serving profile
    and the pre-flight verifier add to the parameter and activation
    formula."""
    out: List[float] = []
    for cfg in model_cfg:
        if cfg.get("layer_type") == attn_layer_type:
            spec = kv_spec_from_config(cfg.get("config", {}), max_len)
            out.append(spec.slab_mb(slots))
        else:
            out.append(0.0)
    return out


__all__ = [
    "KVCacheSpec",
    "PageRequant",
    "PagedWrite",
    "QuantizedPages",
    "QuantizedWrite",
    "SlotKVCachePool",
    "decode_positions",
    "decode_visibility",
    "gather_kv_pages",
    "init_layer_caches",
    "init_paged_caches",
    "kv_mb_per_layer",
    "kv_spec_from_config",
    "paged_kv_mb_per_layer",
    "paged_update_kv",
    "paged_write_plan",
    "quantize_pages",
    "quantized_write_plan",
    "scatter_kv",
    "scatter_paged_kv",
    "scatter_quantized_kv",
    "slab_device",
    "update_kv_cache",
    "write_plan",
]
