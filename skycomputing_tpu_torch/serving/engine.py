"""ServingEngine: iteration-level continuous batching over slot slabs or a
paged KV pool.

The port of ``skycomputing_tpu/serving/engine.py``, both KV layouts, on
one stage or on several: stage placement comes from an allocator-written
worker pool (``worker_manager``, e.g. ``Allocator.serving_allocate``
over a ``DecodeModelBenchmarker``) or an explicit ``partition`` of layer
counts, each stage on ``devices[w.device_index % len(devices)]`` (stages
on one card take turns on it, as the trainer's do).  Every tick the
engine (1) admits queued requests
— through bucketed prefill waves, through swap-in of preempted
requests, or, with ``prefill_chunk`` set, by enrolling them for chunked
prefill — while decode rows AND pages allow, (2) advances chunked
prefill by a budgeted number of chunk waves, and (3) runs one decode
tick over all decode rows: a single-token step, or with ``spec_k > 0`` a
speculative tick (a prefix-slice draft proposes ``spec_k`` tokens, the
target verifies them in one ``Lq = spec_k + 1`` forward).  Requests join
and leave the running batch only between ticks (Orca, OSDI '22).
``static_batching=True`` is the naive baseline on the same steps:
requests join only when the running batch has drained.

The slot layout (``kv_layout="slot"``, the default, as in the
reference) gives every request one row ``[max_len, heads, head_dim]``
of fixed per-layer slabs for its lifetime, so concurrency is capped at
``num_slots``.  A prefill wave fills a bucket-sized scratch cache and
scatters its rows into the wave's slots (pad rows carry the sentinel
slot id and their writes drop); a decode tick runs every slot row with
its own position.  Attention over slot slabs is plain PyTorch, as the
reference's is XLA: no kernel serves the slot layout.  A slot engine
preempts by recomputation only.

The paged layout (``kv_layout="paged"``) keeps KV in per-layer page
pools ``[num_pages, page_size, heads, head_dim]`` addressed through
per-request page tables — in the model
dtype, or with ``kv_dtype="int8"`` as int8 values plus per-page-per-head
float32 scales, quantized at write time.  The host bookkeeping —
free-list allocator, refcounts, radix prefix cache, copy-on-write
grants, chunk budget, preemption policy — is :mod:`.paging`, a verbatim
copy of the JAX package's.  Every step is one function
(``models/gpt.run_paged_step``) at some query length, threaded through
the stages in order (:meth:`ServingEngine._run_paged_stages`); each
attention layer goes through the paged-attention kernel
(``ops/paged_attention.py``; its int8 twin for an int8 pool) on the
card (``attn_impl="plain"`` asks for its plain version instead, as the
reference's bench asks for XLA; ``gather_pages="full"`` gives every step
the whole table width, the baseline the bench measures the live width
against).  One page pool and one row ledger serve every stage: page
``p`` is row ``p`` of every stage's slabs.

A running request can be preempted (:meth:`ServingEngine.preempt`): by
recomputation (it re-queues and its KV is rebuilt by prefill on
re-admission) or by swap (its pages are copied to host memory under a
checksum and scattered back into fresh pages on re-admission, with no
prefill).  The same record carries a request between engines: a
disaggregated fleet's prefill replica detaches it with
:meth:`ServingEngine.export_handoff` (a swap preemption whose record
leaves the engine) and a decode replica seats it with
:meth:`ServingEngine.import_handoff`, which verifies the checksum before
it changes anything.  :meth:`ServingEngine.corrupt_swap_record` flips a
byte of a held record's host copy, the chaos plane's swap fault.

PyTorch runs eagerly, so there are no compiled programs to key, donate
or warm: the slabs are updated in place and the bucket set only bounds
prefill padding.  Inactive decode rows still ride through each step
(``index = 0``; paged: ``valid = 0`` and all-sentinel tables): their
writes drop or land in a free row, and their attention reads stay
inside the slabs.

A worker-manager plan is verified before any slab is allocated
(``analysis/plan_check.verify_plan`` with the serving context: the KV
pages count against each stage's budget).  :meth:`ServingEngine.reconfigure`
changes the operating point in place, verify-then-apply.

Observability is the reference's: ``self.metrics`` (a
``MetricsRegistry`` with the ``"serving"`` source), the live-metrics
mixin's ``enable_timeseries`` / ``start_exporter``, ``_health_snapshot``
for ``/healthz``, and request-scoped tracing: with a tracer enabled,
every request gets a recycled lane carrying its ``queue_wait``,
``prefill`` and ``decode`` segments (attributed to ``trace_name``, the
replica's name in a fleet) and the engine lane its waves, ticks and
admission instants, and each stage's lane the work it issued.  A
``tuning.ServingAutotuner`` attaches itself as ``self.autotuner``; every
``step`` then ends with its ``on_step``.
"""

from __future__ import annotations

import copy
import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..analysis.plan_check import (
    _stage_workers,
    verify_plan,
    verify_tuning_knobs,
)
from ..builder import build_layer_stack
from ..models.gpt import (
    GptEmbeddings,
    _gcfg,
    apply_kv_cached,
    attn_indices,
    decode_modules,
    draft_slice_indices,
    paged_step_inputs,
    run_paged_step,
)
from ..telemetry import LiveMetricsMixin, MetricsRegistry, get_tracer
from ..utils import resolve_device, resolve_devices
from .batcher import (
    AdmissionQueue,
    FAILED,
    FINISHED,
    QueueFullError,
    REJECTED,
    RUNNING,
    Request,
    ShapeBucketer,
)
from .kv_cache import (
    QuantizedPages,
    SlotKVCachePool,
    init_paged_caches,
    kv_spec_from_config,
)
from .paging import (
    ChunkBudgetPolicy,
    PagedKVCachePool,
    RowAllocator,
    choose_preempt_mode,
    pages_for,
)
from .speculative import DraftModel, greedy_accept_count, tree_param_mb


@dataclass
class ServingStats:
    """SLO accounting for a :class:`ServingEngine`.

    Counters are cumulative since engine construction; ``queue_depth``,
    ``batch_occupancy``, ``pages_in_use`` and ``free_pages`` are gauges
    from the last iteration.  ``queue_stalls`` counts iterations where
    admission wanted a row or pages and none were free.  ``prefill_s``
    and ``decode_s`` are host wall time per phase, each ending in the
    device-to-host copy of the step's tokens (so they include the
    device's work).

    The feature counters keep the JAX engine's names and meanings:
    ``preemptions``/``swap_outs``/``swap_ins``/``swap_corruptions``
    (preemption; a corrupt swap record falls back to recompute),
    ``prefill_chunks`` (chunk rows computed) and ``chunk_stalls`` (ticks
    where the chunk budget deferred work), ``quantized_pages`` (page
    tiles re-quantized by writes) and ``dequant_blocks`` (page blocks
    dequantized by attention reads, per step, not per layer),
    ``draft_tokens`` (usable draft proposals), ``accepted_draft_tokens``
    and ``spec_rollbacks``, and the handoff plane's ``handoffs_out``
    (swap records exported as portable handoffs), ``handoffs_in``
    (records seated here for swap-in resume), ``handoff_failures``
    (records refused at the import checksum gate; the request
    recomputes from its prompt) and ``handoff_bytes`` (host payload
    moved, counted once, at export).  ``prefill_waves`` counts chunk
    waves too.
    ``decode_ticks`` counts single-token decode ticks and ``spec_ticks``
    speculative ones (draft + verify); both are the port's own.
    """

    iterations: int = 0
    prefill_waves: int = 0
    prefill_tokens: int = 0
    decode_ticks: int = 0
    spec_ticks: int = 0
    decode_tokens: int = 0
    generated_tokens: int = 0
    admitted: int = 0
    finished: int = 0
    preemptions: int = 0
    queue_stalls: int = 0
    queue_rejections: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    cow_copies: int = 0
    swap_outs: int = 0
    swap_ins: int = 0
    swap_corruptions: int = 0
    prefix_evictions: int = 0
    prefill_chunks: int = 0
    chunk_stalls: int = 0
    quantized_pages: int = 0
    dequant_blocks: int = 0
    draft_tokens: int = 0
    accepted_draft_tokens: int = 0
    spec_rollbacks: int = 0
    handoffs_out: int = 0
    handoffs_in: int = 0
    handoff_failures: int = 0
    handoff_bytes: int = 0
    # gauges
    queue_depth: int = 0
    batch_occupancy: float = 0.0
    pages_in_use: int = 0
    free_pages: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # per-request SLO samples
    ttft_s: List[float] = field(default_factory=list)
    tpot_s: List[float] = field(default_factory=list)

    #: metric classification (``telemetry.MetricsRegistry`` contract):
    #: counters are cumulative for the engine's lifetime, the rest gauges
    FIELD_TYPES = {
        "iterations": "counter", "prefill_waves": "counter",
        "prefill_tokens": "counter", "decode_ticks": "counter",
        "spec_ticks": "counter", "decode_tokens": "counter",
        "generated_tokens": "counter", "admitted": "counter",
        "finished": "counter", "preemptions": "counter",
        "queue_stalls": "counter", "queue_rejections": "counter",
        "prefill_s": "counter", "decode_s": "counter",
        "prefix_hits": "counter", "prefix_tokens_reused": "counter",
        "cow_copies": "counter", "swap_outs": "counter",
        "swap_ins": "counter", "swap_corruptions": "counter",
        "prefix_evictions": "counter",
        "prefill_chunks": "counter", "chunk_stalls": "counter",
        "quantized_pages": "counter", "dequant_blocks": "counter",
        "draft_tokens": "counter",
        "accepted_draft_tokens": "counter",
        "spec_rollbacks": "counter",
        "handoffs_out": "counter", "handoffs_in": "counter",
        "handoff_failures": "counter", "handoff_bytes": "counter",
        "queue_depth": "gauge", "batch_occupancy": "gauge",
        "pages_in_use": "gauge", "free_pages": "gauge",
        "tokens_per_s": "gauge",
        "ttft_p50_s": "gauge", "ttft_p95_s": "gauge",
        "tpot_p50_s": "gauge", "tpot_p95_s": "gauge",
    }

    COUNTER_FIELDS = tuple(
        k for k, v in FIELD_TYPES.items() if v == "counter"
    )

    def tokens_per_s(self) -> float:
        """Generated tokens per second of engine step wall clock."""
        elapsed = self.prefill_s + self.decode_s
        return self.generated_tokens / elapsed if elapsed > 0 else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able summary (percentiles over the SLO samples)."""
        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else None

        snap = {k: v for k, v in self.__dict__.items()
                if k not in ("ttft_s", "tpot_s")}
        snap.update(
            tokens_per_s=self.tokens_per_s(),
            ttft_p50_s=pct(self.ttft_s, 50),
            ttft_p95_s=pct(self.ttft_s, 95),
            tpot_p50_s=pct(self.tpot_s, 50),
            tpot_p95_s=pct(self.tpot_s, 95),
        )
        return snap


class _PagedServingStage:
    """One pipeline stage: module slice + device + per-attention-layer
    page slabs ``[num_pages, page_size, heads, head_dim]``
    (``QuantizedPages`` pairs under ``kv_dtype="int8"``); a stage
    without attention units holds no slabs."""

    def __init__(self, modules: Sequence[Any], state_dicts: Sequence[Any],
                 device: torch.device, num_pages: int, page_size: int,
                 kv_dtype: Optional[str] = None, plain: bool = False):
        self.device = device
        self.kv_dtype = kv_dtype
        self.plain = plain
        self.modules = [m.to_empty(device=device) for m in modules]
        for module, sd in zip(self.modules, state_dicts):
            module.load_state_dict(sd, strict=True)
        self.specs = [
            kv_spec_from_config(self.modules[i].config.to_dict(), page_size)
            for i in attn_indices(self.modules)
        ]
        self.num_pages = int(num_pages)
        self.slabs = self.build_slabs(num_pages, page_size)

    def build_slabs(self, num_pages: int, page_size: int):
        """Fresh zeroed page slabs, one (k, v) pair per attention layer;
        int8 values plus float32 scale slabs under ``kv_dtype="int8"``
        (at construction, and as ``reconfigure``'s pre-build, so an
        allocation failure surfaces while the engine is intact)."""
        return init_paged_caches(self.specs, num_pages, page_size,
                                 device=self.device, kv_dtype=self.kv_dtype)

    def apply_cow_plan(self, plan) -> None:
        """Execute the pool's copy-on-write plan
        (``PagedKVCachePool.cow_plan``) on every layer's slabs, in
        place.  On an int8 pool the plan names the scale row alongside
        the values (a clone dequantized under another scale would
        corrupt the shared prefix).  A plan that does not fit the slabs
        — a scale copy for fp slabs, or int8 slabs without one — is
        pool/stage kv_dtype drift, which raises."""
        copies: Dict[str, Any] = {}
        for kind, src, dst in plan:
            if kind not in ("values", "scales"):
                raise ValueError(f"unknown COW plan entry {kind!r}")
            copies[kind] = (int(src), int(dst))
        if not copies:
            return
        quantized = self.kv_dtype == "int8"
        if ("scales" in copies) != quantized:
            raise ValueError(
                f"COW plan {sorted(copies)} does not fit this stage's "
                f"{'int8' if quantized else 'fp'} slabs — pool/stage "
                f"kv_dtype drift"
            )
        for pair in self.slabs:
            for slab in pair:
                if quantized:
                    s, d = copies["values"]
                    slab.values[d].copy_(slab.values[s])
                    s, d = copies["scales"]
                    slab.scale[d].copy_(slab.scale[s])
                else:
                    s, d = copies["values"]
                    slab[d].copy_(slab[s])

    def swap_out(self, table: np.ndarray) -> List[Any]:
        """Host copies of the pages in ``table`` (sentinel-padded to a
        fixed length; sentinel rows carry garbage the swap-in drops).
        int8 slabs swap their scale rows alongside the values — a page
        restored without its scale would dequantize garbage.  The copy
        is ordered after every step already queued on the device."""
        rows = torch.as_tensor(np.asarray(table, np.int64)).clamp(
            0, self.num_pages - 1).to(self.device)

        def host(slab):
            if isinstance(slab, QuantizedPages):
                return QuantizedPages(slab.values[rows].cpu(),
                                      slab.scale[rows].cpu())
            return slab[rows].cpu()

        return [(host(k), host(v)) for k, v in self.slabs]

    def swap_in(self, table: np.ndarray, host_pairs: List[Any]) -> None:
        """Scatter host page copies back into the pages of ``table``, in
        place; sentinel table rows drop."""
        t = torch.as_tensor(np.asarray(table, np.int64))
        keep = (t >= 0) & (t < self.num_pages)
        src = keep.nonzero()[:, 0]
        dst = t[keep].to(self.device)

        def put(slab, host):
            slab.index_copy_(0, dst, host[src].to(self.device, slab.dtype))

        for (k, v), (hk, hv) in zip(self.slabs, host_pairs):
            for slab, host in ((k, hk), (v, hv)):
                if isinstance(slab, QuantizedPages):
                    put(slab.values, host.values)
                    put(slab.scale, host.scale)
                else:
                    put(slab, host)

    def step(self, data, step_inputs):
        """One paged step through the stage's modules, given the step's
        (table, index, write plan) on this stage's device; returns the
        output."""
        out, self.slabs = run_paged_step(self.modules, data, self.slabs,
                                         step_inputs, self.plain)
        return out


class _SlotServingStage:
    """One pipeline stage under the SLOT layout: module slice + device +
    a :class:`SlotKVCachePool` (per-attention-layer slabs ``[num_slots,
    max_len, heads, head_dim]`` and the stage's slot ledger)."""

    def __init__(self, modules: Sequence[Any], state_dicts: Sequence[Any],
                 device: torch.device, num_slots: int, max_len: int):
        self.device = device
        self.modules = [m.to_empty(device=device) for m in modules]
        for module, sd in zip(self.modules, state_dicts):
            module.load_state_dict(sd, strict=True)
        self.specs = [
            kv_spec_from_config(self.modules[i].config.to_dict(), max_len)
            for i in attn_indices(self.modules)
        ]
        self.pool = SlotKVCachePool(self.specs, num_slots, device=device)

    def build_pool(self, num_slots: int) -> SlotKVCachePool:
        """A fresh pool for a new slot count (``reconfigure``'s
        pre-build, so an allocation failure surfaces while the engine is
        intact)."""
        return SlotKVCachePool(self.specs, num_slots, device=self.device)

    def decode(self, data, index):
        """One decode step over every slot row: ``index`` [num_slots] on
        this stage's device, each row at its own position."""
        out, _ = apply_kv_cached(self.modules, data, self.pool.slabs, index)
        return out

    def prefill(self, data, dst, src):
        """A prefill wave: ``data`` [rows, bucket] through a scratch cache
        the size of the bucket, then scratch row ``src[i]`` copied into
        slot ``dst[i]``'s positions ``[:bucket]`` of every slab (the
        filled scratch is exactly the prefix the slots must hold).  Pad
        rows carry the sentinel slot id and are left out of ``dst`` /
        ``src`` on the host, so their writes drop with no device
        synchronisation."""
        rows, bucket = data.shape[0], data.shape[1]
        scratch = [
            tuple(torch.zeros((rows, bucket, s.num_heads, s.head_dim),
                              dtype=slab.dtype, device=self.device)
                  for slab in pair)
            for s, pair in zip(self.specs, self.pool.slabs)
        ]
        out, scratch = apply_kv_cached(self.modules, data, scratch, 0)
        for filled, pair in zip(scratch, self.pool.slabs):
            for part, slab in zip(filled, pair):
                slab[dst, :bucket] = part[src]
        return out


def _host_leaves(data):
    """The tensors of a swap record's payload, in order.  The payload
    nests as the reference's does: stages -> per-layer (k, v) pairs ->
    a tensor or a ``QuantizedPages`` of values + scale."""
    if isinstance(data, (list, tuple)):
        for item in data:
            yield from _host_leaves(item)
    else:
        yield data


def _leaf_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in memory order (what the checksums fold)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _swap_record_checksum(pages: int, index: int, data: List[Any]) -> str:
    """sha256 over a swap record's host payload: page count, resume
    index and every host tensor's bytes, stage by stage and layer by
    layer (an int8 record's scale rows too).  Stamped at swap-out,
    verified at swap-in."""
    h = hashlib.sha256()
    h.update(f"{int(pages)}:{int(index)}".encode())
    for t in _host_leaves(data):
        h.update(_leaf_bytes(t))
    return h.hexdigest()


def _swap_record_nbytes(data: List[Any]) -> int:
    """Total host bytes a swap record parks."""
    return int(sum(t.numel() * t.element_size() for t in _host_leaves(data)))


def _flip_first_byte(leaf):
    """A copy of a host leaf (a tensor, or a ``QuantizedPages``' values)
    with byte 0 flipped."""
    if isinstance(leaf, QuantizedPages):
        return QuantizedPages(_flip_first_byte(leaf.values), leaf.scale)
    bad = leaf.clone().contiguous()
    raw = bad.reshape(-1).view(torch.uint8)
    raw[0] ^= 0xFF
    return bad


def _stage_slab_checksums(data: List[Any]) -> List[str]:
    """One sha256 per stage's host slabs (the leaf fold of
    :func:`_swap_record_checksum`), so a corrupted handoff names its
    stage."""
    out = []
    for stage_pairs in data:
        h = hashlib.sha256()
        for t in _host_leaves(stage_pairs):
            h.update(_leaf_bytes(t))
        out.append(h.hexdigest())
    return out


class ServingEngine(LiveMetricsMixin):
    """Continuous-batching GPT serving over slot slabs or a paged KV
    pool, on stages placed by an allocator.

    ``model_cfg`` is the layer-config list (``gpt_layer_configs``
    output, the same dicts the JAX package builds); ``params_list`` the
    matching per-layer state dicts (``convert.params_from_jax`` or
    ``models.gpt.random_state_dicts``).

    Placement: ``worker_manager`` (an allocator-written pool; stages in
    the verifier's order, ``plan_check._stage_workers``) or
    ``partition`` (layer counts per stage), else one stage.  Stage ``k``
    runs on ``devices[w.device_index % len(devices)]`` (a partition's
    stage ``k`` on ``devices[k % len(devices)]``).  ``devices`` defaults
    to every CUDA device and ``device`` is the one-device spelling of
    ``devices=[device]``; without a CUDA device construction raises
    unless the caller names the CPU.  With ``preflight`` (the default) a
    worker manager's plan is verified under the serving context before
    any slab is allocated (:class:`~..analysis.PlanError` when a stage's
    KV slabs or pages, parameters and activations outgrow its
    ``mem_limit``).

    Layouts, as in the JAX engine: ``kv_layout="slot"`` (the default)
    holds ``num_slots`` rows of ``max_len``; ``kv_layout="paged"`` holds
    ``num_pages`` pages of ``page_size`` behind per-request tables of
    ``max_pages_per_request`` and decodes ``max_concurrency`` rows.
    ``static_batching`` admits only when the running batch is empty, on
    either layout.

    Paged-only knobs, as in the JAX engine: ``kv_dtype="int8"`` stores
    pages quantized; ``spec_k`` > 0 with ``draft_blocks`` decodes
    speculatively (greedy streams are unchanged); ``prefill_chunk`` (one
    of the buckets) with ``max_chunk_rows`` prefills in budgeted chunks
    that ride ticks beside decode; ``preempt_policy`` ("auto",
    "recompute" or "swap") is the default mode of :meth:`preempt`;
    ``attn_impl`` (None, "plain" or "kernel", the reference's None,
    "xla" and "pallas"): None runs the paged-attention kernel on the
    card and its plain version on the CPU, "kernel" raises on a stage
    off the card, "plain" runs the plain version everywhere;
    ``gather_pages`` ("live" or "full") sizes each step's page table to
    the wave's live span or to ``max_pages_per_request``.
    """

    def __init__(
        self,
        model_cfg: Sequence[Dict],
        params_list: Sequence[Any],
        *,
        num_slots: int = 4,
        max_len: int = 128,
        buckets: Sequence[int] = (16, 32, 64),
        prefill_batch: int = 1,
        max_queue: Optional[int] = None,
        queue_policy: str = "reject",
        pad_id: int = 0,
        static_batching: bool = False,
        kv_layout: str = "slot",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        max_pages_per_request: Optional[int] = None,
        max_concurrency: Optional[int] = None,
        enable_prefix_cache: bool = True,
        max_prefix_entries: int = 256,
        preempt_policy: str = "auto",
        prefill_chunk: Optional[int] = None,
        max_chunk_rows: Optional[int] = None,
        spec_k: int = 0,
        draft_blocks: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        attn_impl: Optional[str] = None,
        gather_pages: str = "live",
        device=None,
        worker_manager=None,
        partition: Optional[Sequence[int]] = None,
        devices: Optional[Sequence[Any]] = None,
        preflight: bool = True,
    ):
        if kv_layout not in ("slot", "paged"):
            raise ValueError(
                f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}"
            )
        if device is not None and devices is not None:
            raise ValueError("pass device OR devices, not both")
        if preempt_policy not in ("auto", "recompute", "swap"):
            raise ValueError(
                f"preempt_policy must be 'auto', 'recompute' or 'swap', "
                f"got {preempt_policy!r}"
            )
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (model dtype) or 'int8', "
                f"got {kv_dtype!r}"
            )
        if attn_impl not in (None, "plain", "kernel"):
            raise ValueError(
                f"attn_impl must be None (by device), 'plain' or "
                f"'kernel', got {attn_impl!r}"
            )
        if gather_pages not in ("live", "full"):
            raise ValueError(
                f"gather_pages must be 'live' or 'full', "
                f"got {gather_pages!r}"
            )
        if queue_policy not in ("reject", "shed"):
            raise ValueError(
                f"queue_policy must be 'reject' or 'shed', "
                f"got {queue_policy!r}"
            )
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        if not self._paged and (kv_dtype is not None
                                or attn_impl is not None
                                or gather_pages != "live"):
            raise ValueError(
                "kv_dtype/attn_impl/gather_pages require "
                "kv_layout='paged' (the kernel, the quantized pool and "
                "the bounded table gather are page-table machinery)"
            )
        if not self._paged and prefill_chunk:
            raise ValueError(
                "prefill_chunk requires kv_layout='paged' (partial "
                "prefill state lives in page tables)"
            )
        if not self._paged and spec_k:
            raise ValueError(
                "spec_k requires kv_layout='paged' (the draft shares the "
                "target's stage-0 page slabs)"
            )
        self.kv_dtype = kv_dtype
        self.gather_pages = gather_pages
        self.static_batching = bool(static_batching)
        self.preempt_policy = preempt_policy
        self._devices = (
            resolve_devices(devices) if devices is not None
            else [resolve_device(device)] if device is not None
            else resolve_devices(None)
        )
        if not self._devices:
            raise ValueError("devices is empty")
        # built on the meta device: each stage materializes its slice on
        # its own device and loads the weights (no throwaway init)
        with torch.device("meta"):
            modules = decode_modules(build_layer_stack(list(model_cfg)))
        if not attn_indices(modules) or not isinstance(
            modules[0], GptEmbeddings
        ):
            raise ValueError(
                "expected a GPT stack: GptEmbeddings + GptBlock_Attn units"
            )
        if len(params_list) != len(modules):
            raise ValueError(
                f"got {len(params_list)} param trees for "
                f"{len(modules)} layers"
            )
        max_pos = _gcfg(modules[0].config).max_position_embeddings
        if self._paged:
            # the paged operating point: max_len becomes the PER-REQUEST
            # virtual span (max_pages_per_request x page_size), and the
            # pool depth decouples from it — num_pages defaults to
            # num_slots requests of max_len each
            self.page_size = int(page_size)
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if max_pages_per_request is not None:
                self.max_pages_per_request = int(max_pages_per_request)
            else:
                # cover max_len, but never round the span past the
                # model's position table
                derived = pages_for(max_len, self.page_size)
                if derived * self.page_size > max_pos:
                    derived = max_pos // self.page_size
                if derived < 1:
                    raise ValueError(
                        f"page_size={self.page_size} exceeds "
                        f"max_position_embeddings={max_pos}"
                    )
                self.max_pages_per_request = derived
            max_len = self.max_pages_per_request * self.page_size
            self.num_pages = (
                int(num_pages) if num_pages is not None
                else int(num_slots) * pages_for(max_len, self.page_size)
            )
            self.max_concurrency = (
                int(max_concurrency) if max_concurrency is not None
                else min(self.num_pages, int(num_slots) * 4)
            )
            if self.max_concurrency < 1:
                raise ValueError(
                    f"max_concurrency must be >= 1, "
                    f"got {self.max_concurrency}"
                )
            # decode rows are the concurrency lanes ("slots")
            num_slots = self.max_concurrency
        else:
            self.page_size = None
            self.num_pages = None
            self.max_pages_per_request = None
            self.max_concurrency = None
        if max_len > max_pos:
            raise ValueError(
                f"max_len={max_len} exceeds "
                f"max_position_embeddings={max_pos}"
            )
        self.bucketer = ShapeBucketer(buckets)
        if self.bucketer.max_bucket > max_len:
            raise ValueError(
                f"largest bucket {self.bucketer.max_bucket} exceeds "
                f"max_len={max_len}"
            )
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.pad_id = int(pad_id)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queue_policy = queue_policy
        self.prefill_batch = int(prefill_batch)
        self._queue = AdmissionQueue(
            self.bucketer, prefill_batch=prefill_batch,
            max_queue=self.max_queue,
        )
        # chunked prefill: split the non-shared prefill tail into
        # prefill_chunk-token chunks that ride ticks beside decode
        self.prefill_chunk: Optional[int] = None
        self.max_chunk_rows: Optional[int] = None
        self._chunk_policy: Optional[ChunkBudgetPolicy] = None
        if prefill_chunk:
            self._set_chunking(int(prefill_chunk), max_chunk_rows)
        elif max_chunk_rows is not None:
            raise ValueError("max_chunk_rows requires prefill_chunk")
        # speculative decoding: a prefix-slice draft proposes spec_k
        # tokens per tick, the target verifies all spec_k + 1 positions
        # in one forward
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.draft_blocks = (
            int(draft_blocks) if draft_blocks is not None else None
        )
        if self.spec_k > 0 and self.draft_blocks is None:
            raise ValueError(
                "spec_k > 0 requires draft_blocks (the prefix-slice "
                "depth of the draft model)"
            )
        self.stats = ServingStats()
        # one registry source, read by the time series and the exporter
        self.metrics = MetricsRegistry()
        self.metrics.register("serving", lambda: self.stats.snapshot(),
                              types=ServingStats.FIELD_TYPES)
        # request-scoped trace segments carry this name (a fleet sets
        # the replica's)
        self.trace_name = "engine"
        self.timeseries = None
        self._running: Dict[int, Request] = {}
        # chunked-prefill ledger: requests holding a page grant and a
        # decode row whose prefilled_len watermark has not reached the
        # end of their effective prompt (insertion order = enrollment
        # FIFO, which chunk waves honor head-first)
        self._prefilling: Dict[int, Request] = {}
        self._finished: List[Request] = []
        # closed-loop tuning: a ``tuning.ServingAutotuner`` attaches
        # itself here, and every step ends with its observe/decide call
        self.autotuner = None
        # kept for reconfigure's second pre-flight against a proposed
        # operating point (the opt-out carries over)
        self._model_cfg = list(model_cfg)
        self._worker_manager = worker_manager
        self._preflight = bool(preflight)
        self._enable_prefix_cache = bool(enable_prefix_cache)
        self._max_prefix_entries = int(max_prefix_entries)
        counts, stage_devices = self._resolve_stage_plan(
            worker_manager, partition, len(modules)
        )
        if self._paged:
            on_card = all(d.type == "cuda" for d in stage_devices)
            if attn_impl == "kernel" and not on_card:
                raise ValueError(
                    "attn_impl='kernel' needs every stage on a CUDA "
                    "device; the kernel has no CPU build"
                )
            self.attn_impl = attn_impl or ("kernel" if on_card else "plain")
        else:
            self.attn_impl = None
        # the draft's only resident charge: the LM head's parameters on
        # stage 0 when the head lives on another stage — known before
        # the pre-flight, which charges it
        self._draft_mb = (
            tree_param_mb(list(params_list)[-1])
            if self.spec_k > 0 and len(counts) > 1 else 0.0
        )
        if preflight and worker_manager is not None:
            # slabs allocate below: an over-budget serving plan fails
            # here, before any of them exists, naming the serving context
            verify_plan(
                self._model_cfg, worker_manager,
                (np.zeros((self.num_slots, 1), np.int32),),
                memory="error", check_donation=False,
                serving=self._serving_context(),
            ).raise_if_failed()
        # swap records: request_id -> host page copies + resume state
        # (paged only; a slot engine preempts by recomputation)
        self._swapped: Dict[int, Dict[str, Any]] = {}
        # banked totals of pools a geometry reconfigure replaced, so an
        # engine-lifetime counter never goes backwards
        self._pool_base = dict(prefix_hits=0, prefix_tokens_reused=0,
                               cow_copies=0, prefix_evictions=0)
        if self._paged:
            # ONE page pool governs the page-id space of every stage
            # (page p is row p of each stage's slabs) and one row ledger
            # the decode rows
            self._pool = PagedKVCachePool(
                self.num_pages, self.page_size, self.max_pages_per_request,
                enable_prefix_cache=self._enable_prefix_cache,
                max_prefix_entries=self._max_prefix_entries,
                kv_dtype=self._pool_kv_dtype(),
            )
            self._rows = RowAllocator(self.max_concurrency)
        else:
            # slot ids are global across stages: each stage's pool holds
            # the same ids (allocated on stage 0, acquired on the rest)
            self._pool = None
            self._rows = None
        self.stages: List[Any] = []
        cursor = 0
        for n, dev in zip(counts, stage_devices):
            mods = modules[cursor:cursor + n]
            sds = list(params_list)[cursor:cursor + n]
            if self._paged:
                self.stages.append(_PagedServingStage(
                    mods, sds, dev, self.num_pages, self.page_size,
                    kv_dtype=kv_dtype, plain=attn_impl == "plain",
                ))
            else:
                self.stages.append(_SlotServingStage(
                    mods, sds, dev, self.num_slots, self.max_len))
            cursor += n
        # trace-lane names: the analysis keys stage occupancy on the
        # "stage N" prefix, as it does for the training pipeline's
        for i, st in enumerate(self.stages):
            st.lane_name = f"stage {i} [{st.device}]"
        # token ids enter on stage 0's device, logits leave the last's
        self.device = self.stages[0].device
        self._last_device = self.stages[-1].device
        self._draft: Optional[DraftModel] = None
        if self.spec_k > 0:
            self._draft = self._build_draft()
            self._draft_mb = self._draft.extra_param_mb

    def _pool_kv_dtype(self) -> str:
        """The page pool's storage dtype: the quantization knob when set,
        else the model dtype — what the allocator accounts and the
        verifier charges (one formula, ``paging.paged_pool_mb``)."""
        if self.kv_dtype is not None:
            return self.kv_dtype
        return str(_gcfg(self._model_cfg[0]["config"]).dtype)

    def _serving_context(self) -> Dict[str, Any]:
        """The operating point the pre-flight verifier charges."""
        if not self._paged:
            return dict(slots=self.num_slots, max_len=self.max_len,
                        bucket=self.bucketer.max_bucket)
        ctx = dict(
            num_pages=self.num_pages, page_size=self.page_size,
            max_pages_per_request=self.max_pages_per_request,
            bucket=self.bucketer.max_bucket,
        )
        if self.kv_dtype is not None:
            # the quantized width (+ scale slabs) is what the slabs
            # allocate: the verifier charges the same formula
            ctx["kv_dtype"] = self.kv_dtype
        if self._draft_mb:
            ctx["draft_mb"] = self._draft_mb
        return ctx

    def _resolve_stage_plan(self, worker_manager, partition,
                            n_layers: int):
        """(layer counts, devices) per stage, from an allocator-written
        worker pool, an explicit partition, or the one-stage default."""
        if worker_manager is not None and partition is not None:
            raise ValueError("pass worker_manager OR partition, not both")
        n_dev = len(self._devices)
        if worker_manager is not None:
            # the verifier's stage order (rank-sorted non-empty
            # workers): one definition, so engine and pre-flight agree
            workers = _stage_workers(worker_manager)
            counts = [len(w.model_config) for w in workers]
            stage_devices = [self._devices[w.device_index % n_dev]
                             for w in workers]
        else:
            counts = ([int(c) for c in partition]
                      if partition is not None else [n_layers])
            stage_devices = [self._devices[k % n_dev]
                             for k in range(len(counts))]
        if sum(counts) != n_layers or any(c < 1 for c in counts):
            raise ValueError(
                f"partition {counts} does not cover {n_layers} layers"
            )
        return counts, stage_devices

    def _build_draft(self) -> DraftModel:
        """The prefix-slice draft on stage 0 (fallible: called before any
        state changes, at construction and when ``reconfigure`` turns
        speculation on).

        The draft's layers are stage 0's own modules, reading and
        writing stage 0's first slab pairs.  With more than one stage
        the LM head lives on the last: the draft runs it on stage 0's
        device, moving a copy there only when the devices differ (stages
        that share a card share the head's parameters).  The charge,
        ``extra_param_mb``, is the head's parameter MB whenever there is
        more than one stage, as the reference charges it, so both
        verifiers report the same plan alike."""
        full_modules = [m for st in self.stages for m in st.modules]
        idx = draft_slice_indices(full_modules, self.draft_blocks)
        cut = idx[-2] + 1  # prefix length (idx = range(cut) + [head])
        stage0, last = self.stages[0], self.stages[-1]
        if cut > len(stage0.modules):
            raise ValueError(
                f"draft_blocks={self.draft_blocks} needs the first "
                f"{cut} layers resident on stage 0, which holds only "
                f"{len(stage0.modules)} — shrink the draft or deepen "
                f"stage 0 (the draft shares stage 0's params and slabs)"
            )
        head = full_modules[-1]
        if last.device != stage0.device:
            head = copy.deepcopy(head).to(stage0.device)
        return DraftModel(list(stage0.modules[:cut]) + [head],
                          extra_param_mb=self._pending_draft_mb(),
                          plain=stage0.plain)

    def _pending_draft_mb(self) -> float:
        """The draft memory turning speculation on would ADD to stage 0
        (the LM head's parameters; 0 with one stage), computed without
        allocating anything so the pre-flight can charge it first."""
        if len(self.stages) <= 1:
            return 0.0
        return tree_param_mb(self.stages[-1].modules[-1])

    def _set_chunking(self, prefill_chunk: int,
                      max_chunk_rows: Optional[int]) -> None:
        """Validate + install the chunked-prefill operating point.
        ``prefill_chunk`` must be one of the prefill buckets, as in the
        JAX engine (chunk waves take the bucket shapes)."""
        if prefill_chunk not in self.bucketer.buckets:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be one of the "
                f"prefill buckets {list(self.bucketer.buckets)}"
            )
        rows = (
            int(max_chunk_rows) if max_chunk_rows is not None
            else self.prefill_batch
        )
        self._chunk_policy = ChunkBudgetPolicy(
            prefill_chunk, max_chunk_rows=rows,
            idle_chunk_rows=max(rows, self.prefill_batch * 2),
        )
        self.prefill_chunk = int(prefill_chunk)
        self.max_chunk_rows = rows

    # --- reconfigure: a new operating point in place -----------------------
    def reconfigure(
        self,
        *,
        buckets: Optional[Sequence[int]] = None,
        num_slots: Optional[int] = None,
        prefill_batch: Optional[int] = None,
        num_pages: Optional[int] = None,
        page_size: Optional[int] = None,
        max_pages_per_request: Optional[int] = None,
        max_concurrency: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        max_chunk_rows: Optional[int] = None,
        spec_k: Optional[int] = None,
    ) -> None:
        """Apply a new serving operating point IN PLACE, between steps
        (the reference's ``reconfigure``).

        Slot engines: ``buckets`` and ``prefill_batch`` evict nothing
        (the queue re-buckets; running requests keep decoding);
        ``num_slots`` rebuilds every stage's slabs and re-seats the
        running batch recomputation-style.  The page knobs raise.

        Paged engines: ``buckets`` and ``prefill_batch`` evict nothing
        (the queue re-buckets); ``max_concurrency`` (``num_slots`` is its
        alias here: decode rows are the paged engine's slots) re-seats
        the running batch recomputation-style on the SAME pool, swap
        records intact; ``num_pages`` / ``page_size`` /
        ``max_pages_per_request`` rebuild the pool and every stage's
        slabs — running requests resume by recomputation, the prefix
        cache restarts cold with its counters banked, and swap records
        (whose page shapes died) become recompute resumes.
        ``prefill_chunk`` and ``spec_k``: None keeps, 0 disables;
        disabling chunking re-queues mid-prefill requests; enabling
        speculation needs an engine built with ``draft_blocks``.

        Verify, then apply: :func:`~..analysis.plan_check.verify_tuning_knobs`,
        then (an engine built from a worker manager, on a geometry
        change, a larger bucket or a draft newly made resident) the
        serving pre-flight again, charged at old + new pool depth for a
        geometry change (both pools are held for a moment), then every
        live request proven to fit, then every stage's new slabs, the
        pool and the draft built — all before any state changes, so a
        rejected reconfigure (``PlanError``, ``ValueError``, an
        allocation failure) leaves the engine exactly as it was.
        """
        if buckets is not None:
            # the constructor's normalisation; a malformed entry stays
            # raw for the knob verifier to name
            try:
                new_buckets = tuple(sorted(set(int(b) for b in buckets)))
            except (TypeError, ValueError):
                new_buckets = tuple(buckets)
        else:
            new_buckets = self.bucketer.buckets
        if not self._paged:
            if any(k is not None for k in
                   (num_pages, page_size, max_pages_per_request,
                    max_concurrency, prefill_chunk, max_chunk_rows,
                    spec_k)):
                raise ValueError(
                    "page knobs (num_pages/page_size/max_pages_per_request"
                    "/max_concurrency/prefill_chunk/max_chunk_rows/spec_k) "
                    "require kv_layout='paged'"
                )
            self._reconfigure_slots(new_buckets, num_slots, prefill_batch)
            return
        if max_concurrency is not None and num_slots is not None and (
                int(max_concurrency) != int(num_slots)):
            raise ValueError(
                "num_slots aliases max_concurrency on a paged engine; "
                f"got conflicting {num_slots} and {max_concurrency}"
            )
        new_rows = int(
            max_concurrency if max_concurrency is not None
            else num_slots if num_slots is not None
            else self.max_concurrency
        )
        new_batch = (int(prefill_batch) if prefill_batch is not None
                     else self.prefill_batch)
        new_pages = int(num_pages) if num_pages is not None \
            else self.num_pages
        new_psize = int(page_size) if page_size is not None \
            else self.page_size
        new_mpr = (int(max_pages_per_request)
                   if max_pages_per_request is not None
                   else self.max_pages_per_request)
        new_virtual = new_mpr * new_psize if (
            new_mpr > 0 and new_psize > 0) else self.max_len
        new_chunk = (self.prefill_chunk if prefill_chunk is None
                     else (int(prefill_chunk) or None))
        new_chunk_rows = (int(max_chunk_rows) if max_chunk_rows is not None
                          else self.max_chunk_rows)
        if max_chunk_rows is not None and new_chunk is None:
            raise ValueError("max_chunk_rows requires prefill_chunk")
        new_spec = self.spec_k if spec_k is None else int(spec_k)
        verify_tuning_knobs(
            buckets=new_buckets, max_len=new_virtual,
            num_slots=new_rows, prefill_batch=new_batch,
            num_pages=new_pages, page_size=new_psize,
            max_pages_per_request=new_mpr,
            prefill_chunk=new_chunk, spec_k=new_spec,
        ).raise_if_failed()
        if new_spec > 0 and self._draft is None and (
                self.draft_blocks is None):
            raise ValueError(
                "reconfigure rejected: spec_k > 0 requires an engine "
                "built with draft_blocks (the draft's layer slice is "
                "construction state)"
            )
        max_pos = _gcfg(
            self.stages[0].modules[0].config).max_position_embeddings
        if new_virtual > max_pos:
            raise ValueError(
                f"max_pages_per_request x page_size = {new_virtual} "
                f"exceeds max_position_embeddings={max_pos}"
            )
        geometry_change = (
            new_pages != self.num_pages or new_psize != self.page_size
            or new_mpr != self.max_pages_per_request
        )
        must_evict = geometry_change or new_rows != self.max_concurrency
        # turning speculation on makes the draft's head newly resident
        # on stage 0: the verifier sees it before it exists
        enabling_spec = new_spec > 0 and self._draft is None
        charged_draft_mb = (self._pending_draft_mb() if enabling_spec
                            else self._draft_mb)
        if (self._preflight and self._worker_manager is not None
                and (geometry_change
                     or max(new_buckets) > self.bucketer.max_bucket
                     or (enabling_spec and charged_draft_mb > 0))):
            # a geometry change pre-builds a second slab set while the
            # old one is resident: charge the transient peak
            charged = new_pages + (self.num_pages if geometry_change else 0)
            ctx = dict(num_pages=charged, page_size=new_psize,
                       max_pages_per_request=new_mpr,
                       bucket=max(new_buckets))
            if self.kv_dtype is not None:
                ctx["kv_dtype"] = self.kv_dtype
            if charged_draft_mb > 0:
                ctx["draft_mb"] = charged_draft_mb
            verify_plan(
                self._model_cfg, self._worker_manager,
                (np.zeros((new_rows, 1), np.int32),),
                memory="error", check_donation=False, serving=ctx,
            ).raise_if_failed()
        new_bucketer = ShapeBucketer(new_buckets)
        # feasibility before any change: swap records survive only a
        # geometry-preserving change, so under one every swapped request
        # must be able to resume by recomputation
        live = (list(self._running.values())
                + list(self._prefilling.values())
                + list(self._queue.requests))
        for r in live:
            length = int(r.effective_prompt.size)
            if length + r.remaining > new_virtual:
                raise ValueError(
                    f"reconfigure rejected: request {r.request_id} "
                    f"spans {length + r.remaining} positions; the new "
                    f"virtual span is {new_virtual}"
                )
            if r.request_id in self._swapped and not geometry_change:
                continue  # resumes from host pages, needs no bucket
            try:
                new_bucketer.bucket_for(length)
            except ValueError as exc:
                raise ValueError(
                    f"reconfigure rejected: request {r.request_id} "
                    f"cannot resume under buckets {list(new_buckets)}: "
                    f"{exc}"
                ) from None
        # build everything fallible before touching request state
        new_slabs = ([st.build_slabs(new_pages, new_psize)
                      for st in self.stages] if geometry_change else None)
        new_pool = PagedKVCachePool(
            new_pages, new_psize, new_mpr,
            enable_prefix_cache=self._enable_prefix_cache,
            max_prefix_entries=self._max_prefix_entries,
            kv_dtype=self._pool_kv_dtype(),
        ) if geometry_change else None
        new_row_alloc = RowAllocator(new_rows) if must_evict else None
        new_policy = None
        if new_chunk is not None:
            rows = new_chunk_rows if new_chunk_rows is not None \
                else new_batch
            new_policy = ChunkBudgetPolicy(
                new_chunk, max_chunk_rows=rows,
                idle_chunk_rows=max(rows, new_batch * 2),
            )
        new_draft = self._draft
        if new_spec > 0 and new_draft is None:
            new_draft = self._build_draft()

        evicted: List[Request] = []
        tracer = get_tracer()

        def evict(r: Request, prefilling: bool) -> None:
            if prefilling:
                self._prefilling.pop(r.request_id)
                r.prefilled_len = 0  # recompute replays the tail
            else:
                self._running.pop(r.request_id)
            self._rows.release(r.slot)
            self._pool.release(r.request_id)
            r.slot = None
            r.preemptions += 1
            self.stats.preemptions += 1
            evicted.append(r)
            self._trace_preempted(r, tracer, reconfigure=True)

        if must_evict:
            for r in list(self._running.values()):
                evict(r, prefilling=False)
            for r in list(self._prefilling.values()):
                evict(r, prefilling=True)
        elif new_chunk is None and self._prefilling:
            # chunking turned off mid-watermark: no chunk tick would
            # finish them, so they re-queue recompute-style
            for r in list(self._prefilling.values()):
                evict(r, prefilling=True)
        queued = self._queue.drain()
        for r in queued:
            self._trace_close(r, tracer, "queued", rebucketed=True)
        if geometry_change:
            for key in self._pool_base:
                self._pool_base[key] += getattr(self._pool, key)
            self._pool = new_pool
            for st, slabs in zip(self.stages, new_slabs):
                st.num_pages = new_pages
                st.slabs = slabs
            self._swapped.clear()
            self.num_pages = new_pages
            self.page_size = new_psize
            self.max_pages_per_request = new_mpr
            self.max_len = new_virtual
        if new_row_alloc is not None:
            self._rows = new_row_alloc
            self.max_concurrency = new_rows
            self.num_slots = new_rows
        self.bucketer = new_bucketer
        self.prefill_batch = new_batch
        self.prefill_chunk = new_chunk
        self.max_chunk_rows = (new_policy.max_chunk_rows
                               if new_policy is not None else None)
        self._chunk_policy = new_policy
        self.spec_k = new_spec
        if new_spec > 0:
            self._draft = new_draft
            self._draft_mb = new_draft.extra_param_mb
        self._queue = AdmissionQueue(new_bucketer, prefill_batch=new_batch,
                                     max_queue=self.max_queue)
        # evicted requests were admitted before anything still queued:
        # they re-enter at the head
        for r in evicted + queued:
            self._queue.submit(
                r, force=True,
                require_bucket=r.request_id not in self._swapped)
            self._trace_queued(r, tracer)
        self.stats.queue_depth = self._queue.depth
        if tracer is not None:
            tracer.instant(
                "reconfigure", tracer.lane("serving", "engine"),
                dict(new=dict(buckets=list(new_bucketer.buckets),
                              max_concurrency=self.max_concurrency,
                              prefill_batch=new_batch,
                              num_pages=self.num_pages,
                              page_size=self.page_size,
                              prefill_chunk=new_chunk, spec_k=new_spec),
                     evicted=len(evicted)),
            )

    def _reconfigure_slots(self, new_buckets, num_slots,
                           prefill_batch) -> None:
        """The slot layout's verify-then-apply: knobs verified, the
        serving pre-flight again (an engine built from a worker manager,
        on a slot-count change or a larger bucket; a slot change charged
        at old + new slots, both pools being held for a moment), every
        live request proven to fit the new buckets, and every stage's new
        pool built, before any state changes."""
        new_slots = (int(num_slots) if num_slots is not None
                     else self.num_slots)
        new_batch = (int(prefill_batch) if prefill_batch is not None
                     else self.prefill_batch)
        verify_tuning_knobs(
            buckets=new_buckets, max_len=self.max_len,
            num_slots=new_slots, prefill_batch=new_batch,
        ).raise_if_failed()
        if (self._preflight and self._worker_manager is not None
                and (new_slots != self.num_slots
                     or max(new_buckets) > self.bucketer.max_bucket)):
            charged = new_slots + (
                self.num_slots if new_slots != self.num_slots else 0)
            verify_plan(
                self._model_cfg, self._worker_manager,
                (np.zeros((new_slots, 1), np.int32),),
                memory="error", check_donation=False,
                serving=dict(slots=charged, max_len=self.max_len,
                             bucket=max(new_buckets)),
            ).raise_if_failed()
        new_bucketer = ShapeBucketer(new_buckets)
        # only a slot-count change rebuilds the slabs and evicts; the
        # running batch must still fit a bucket either way (a request
        # that fits none could never be preempted again)
        must_evict = new_slots != self.num_slots
        for r in list(self._running.values()) + list(self._queue.requests):
            try:
                new_bucketer.bucket_for(int(r.effective_prompt.size))
            except ValueError as exc:
                raise ValueError(
                    f"reconfigure rejected: request {r.request_id} "
                    f"cannot resume under buckets {list(new_buckets)}: "
                    f"{exc}"
                ) from None
        new_pools = ([st.build_pool(new_slots) for st in self.stages]
                     if must_evict else None)
        evicted: List[Request] = []
        tracer = get_tracer()
        if must_evict:
            for r in list(self._running.values()):
                self._running.pop(r.request_id)
                self._release_slot(r.slot)
                r.slot = None
                r.preemptions += 1
                self.stats.preemptions += 1
                evicted.append(r)
                self._trace_preempted(r, tracer, reconfigure=True)
        queued = self._queue.drain()
        for r in queued:
            self._trace_close(r, tracer, "queued", rebucketed=True)
        if new_pools is not None:
            self.num_slots = new_slots
            for st, pool in zip(self.stages, new_pools):
                st.pool = pool
        self.bucketer = new_bucketer
        self.prefill_batch = new_batch
        self._queue = AdmissionQueue(new_bucketer, prefill_batch=new_batch,
                                     max_queue=self.max_queue)
        # evicted requests were admitted before anything still queued:
        # they re-enter at the head
        for r in evicted + queued:
            self._queue.submit(r, force=True)
            self._trace_queued(r, tracer)
        self.stats.queue_depth = self._queue.depth
        if tracer is not None:
            tracer.instant(
                "reconfigure", tracer.lane("serving", "engine"),
                dict(new=dict(buckets=list(new_buckets), slots=new_slots,
                              prefill_batch=new_batch),
                     evicted=len(evicted)),
            )

    # --- the swap plane's fault and the prefill/decode handoff plane ------
    def corrupt_swap_record(self, request_id: Optional[int] = None, *,
                            force: bool = False) -> Optional[int]:
        """Flip byte 0 of a held swap record's host copy (stage 0, layer
        0, K values): the chaos plane's ``swap_corruption`` fault, host
        memory rot applied through the record, never to a device page.

        Targets ``request_id``'s record when given, else the oldest held
        record.  With ``force`` and nothing parked, the oldest running
        request is swapped out first through :meth:`preempt`.  Returns
        the corrupted record's request id, or None when no record exists
        and none can be forced."""
        if not self._paged:
            raise ValueError("swap records exist on paged engines only")
        if request_id is not None:
            if request_id not in self._swapped:
                raise KeyError(f"request {request_id} holds no swap record")
            rid = request_id
        elif self._swapped:
            rid = min(self._swapped)
        else:
            rid = None
            if force:
                for cand in sorted(self._running):
                    try:
                        self.preempt(cand, mode="swap")
                    except (ValueError, KeyError):
                        continue
                    rid = cand
                    break
            if rid is None:
                return None
        pairs = self._swapped[rid]["data"][0]
        pairs[0] = (_flip_first_byte(pairs[0][0]), pairs[0][1])
        return rid

    def export_handoff(self, request_id: int) -> tuple:
        """Detach a decoding request as a portable handoff: the request
        (token stream intact) and its swap record (host page copies and
        checksum), for another engine's :meth:`import_handoff`.

        Rides :meth:`preempt` in ``swap`` mode, so an export counts as a
        preemption and a swap-out; the record is then popped and the
        request leaves the queue, and this engine holds nothing of it.
        Only a request past prefill exports: a mid-prefill or finished
        one raises."""
        if not self._paged:
            raise ValueError(
                "handoff export needs a paged engine (swap records are "
                "the carrier)"
            )
        request = self._running.get(request_id)
        if request is None:
            raise KeyError(f"request {request_id} is not decoding here")
        if not request.tokens:
            raise ValueError(
                "a request hands off only after prefill seeded its "
                "first token"
            )
        if request.done:
            raise ValueError(
                "a finished request has nothing left to hand off"
            )
        self.preempt(request_id, mode="swap")
        record = self._swapped.pop(request_id)
        self._queue.remove(request)
        self.stats.queue_depth = self._queue.depth
        self.stats.handoffs_out += 1
        self.stats.handoff_bytes += _swap_record_nbytes(record["data"])
        tracer = get_tracer()
        if tracer is not None:
            tracer.instant(
                "handoff_out", tracer.lane("serving", "engine"),
                {"request": request_id, "pages": record["pages"]},
            )
            # the queue segment preempt opened ends here: the request
            # leaves this engine (the importing side opens its own)
            self._trace_close(request, tracer, "queued", drained=True)
        return request, record

    def import_handoff(self, request: Request, record: dict) -> bool:
        """Seat an exported handoff for swap-in resume, its checksum
        verified before the record touches any engine state.

        True: the record is parked, and admission's swap-in restores its
        pages with no prefill.  False: the checksum did not match (or the
        payload cannot fit this engine); ``handoff_failures`` counts it
        and the request re-queues to recompute from its prompt, or is
        FAILED with a reason when its resume prefix fits no bucket."""
        if not self._paged:
            raise ValueError(
                "handoff import needs a paged engine (swap records are "
                "the carrier)"
            )
        rid = request.request_id
        if (rid in self._running or rid in self._prefilling
                or rid in self._swapped
                or any(r is request for r in self._queue.requests)):
            raise ValueError(f"request {rid} is already live on this engine")
        pages = record.get("pages")
        index = record.get("index")
        data = record.get("data")
        ok = (
            isinstance(pages, int) and 1 <= pages
            and pages <= self.max_pages_per_request
            and isinstance(index, int) and index >= 1
            and isinstance(data, list) and len(data) == len(self.stages)
        )
        if ok:
            expect = record.get("checksum")
            ok = (expect is not None
                  and _swap_record_checksum(pages, index, data) == expect)
        tracer = get_tracer()
        if ok:
            self._swapped[rid] = record
            # the bytes were counted once, at export
            self.stats.handoffs_in += 1
        else:
            self.stats.handoff_failures += 1
            if tracer is not None:
                tracer.instant(
                    "handoff_corrupt", tracer.lane("serving", "engine"),
                    {"request": rid},
                )
            try:
                self.bucketer.bucket_for(int(request.effective_prompt.size))
            except ValueError:
                request.status = FAILED
                request.fail_reason = (
                    "handoff record corrupted and the resume prefix "
                    "fits no bucket"
                )
                return False
        # force: the request was admitted on the exporting pool; a
        # verified record resumes bucket-free, a refused one re-buckets
        self._queue.submit(request, force=True, require_bucket=not ok)
        self.stats.queue_depth = self._queue.depth
        if tracer is not None:
            tracer.instant(
                "handoff_in", tracer.lane("serving", "engine"),
                {"request": rid, "verified": ok},
            )
        self._trace_queued(request, tracer)
        return ok

    # --- request lifecycle --------------------------------------------------
    @property
    def free_slots(self) -> int:
        if self._paged:
            return self._rows.free_slots
        return self.stages[0].pool.free_slots

    def _allocate_slot(self) -> Optional[int]:
        """A slot id held on every stage (slot layout), or a decode row
        (paged); None when none is free."""
        if self._paged:
            return self._rows.allocate()
        slot = self.stages[0].pool.allocate()
        if slot is not None:
            for st in self.stages[1:]:
                st.pool.acquire(slot)
        return slot

    def _release_slot(self, slot: int) -> None:
        if self._paged:
            self._rows.release(slot)
            return
        for st in self.stages:
            st.pool.release(slot)

    @property
    def queued_requests(self) -> List[Request]:
        return list(self._queue.requests)

    @property
    def running_requests(self) -> List[Request]:
        """Requests holding a decode row, mid-prefill ones included."""
        return list(self._prefilling.values()) + list(
            self._running.values()
        )

    # --- request-scoped tracing ---------------------------------------------
    # One stable id (request_id) threads the whole waterfall: every
    # segment lands on the request's recycled lane with a {"request",
    # "replica"} attribution, and the open-segment mark lives on the
    # Request itself, so whoever ends the segment (this engine, another
    # after a migration, or the fleet over a dead replica) can close it.
    # Every helper is a no-op with tracing disabled (tracer is None).

    def _trace_queued(self, request: Request, tracer) -> None:
        """Open a ``queue_wait`` segment (mark + ``queued`` instant)."""
        if tracer is None:
            return
        request.trace_marks["queued"] = tracer.now()
        lane = tracer.request_lane(request.request_id)
        if lane is not None:
            tracer.instant(
                "queued", lane,
                {"request": request.request_id,
                 "replica": self.trace_name},
            )

    def _trace_close(self, request: Request, tracer, segment: str,
                     end_us: Optional[float] = None, **extra) -> None:
        """Close the request's open ``segment`` (``"queued"`` closes as
        ``queue_wait``), if any."""
        if tracer is None:
            return
        mark = request.trace_marks.pop(segment, None)
        if mark is None:
            return
        lane = tracer.request_lane(request.request_id, lease=False)
        if lane is None:
            return
        args = {"request": request.request_id, "replica": self.trace_name}
        if segment == "decode":
            args["tokens"] = len(request.tokens)
        args.update(extra)
        end = tracer.now() if end_us is None else end_us
        name = "queue_wait" if segment == "queued" else segment
        tracer.complete(name, lane, mark, args, dur_us=end - mark)

    def _trace_preempted(self, request: Request, tracer, **args) -> None:
        """Engine-lane ``preempt`` instant; the request's decode (or
        chunked prefill) segment ends here."""
        if tracer is None:
            return
        tracer.instant("preempt", tracer.lane("serving", "engine"),
                       dict({"request": request.request_id}, **args))
        extra = {k: v for k, v in args.items() if k != "mode"} \
            or {"preempted": True}
        self._trace_close(request, tracer, "decode", **extra)
        self._trace_close(request, tracer, "prefill", **extra)

    def _trace_wave(self, tracer, span0: float, name: str,
                    members: Sequence[Request], args: Dict[str, Any],
                    admitted: bool) -> Optional[float]:
        """Engine-lane ``name`` span over a wave or tick; a prefill
        wave that ``admitted`` its members also closes their queue
        segments at ``span0``, lays each a ``prefill`` segment and opens
        its decode segment at the wave's end.  Returns the end mark."""
        if tracer is None:
            return None
        end_us = tracer.now()
        tracer.complete(name, tracer.lane("serving", "engine"), span0,
                        dict(args, requests=[r.request_id
                                             for r in members]),
                        dur_us=end_us - span0)
        if not admitted:
            return end_us
        for r in members:
            tracer.instant("admit", tracer.lane("serving", "engine"),
                           {"request": r.request_id, "slot": r.slot})
            self._trace_close(r, tracer, "queued", end_us=span0)
            lane = tracer.request_lane(r.request_id, lease=False)
            if lane is not None:
                tracer.complete(
                    "prefill", lane, span0,
                    {"request": r.request_id, "replica": self.trace_name,
                     "bucket": args.get("bucket"), "slot": r.slot},
                    dur_us=end_us - span0,
                )
            r.trace_marks["decode"] = end_us
        return end_us

    def submit(self, request: Request, *, force: bool = False) -> Request:
        """Queue a request (admitted on a later ``step``).

        With ``max_queue`` set, a full queue applies ``queue_policy``:
        ``"reject"`` refuses the newcomer (:class:`QueueFullError`
        propagates); ``"shed"`` displaces the oldest token-less queued
        request(s), marking them ``REJECTED``, and degrades to reject
        when nothing is sheddable.  ``stats.queue_rejections`` counts
        every turned-away request.  ``force=True`` bypasses the bound.
        """
        length = int(request.effective_prompt.size)
        if length + request.remaining > self.max_len:
            raise ValueError(
                f"prompt ({length}) + new tokens ({request.remaining}) "
                f"exceed max_len={self.max_len}"
            )
        tracer = get_tracer()
        try:
            self._queue.submit(request, force=force)
        except QueueFullError:
            if self.queue_policy == "shed":
                while self._queue.depth >= (self.max_queue or 0):
                    shed = self._queue.shed_oldest()
                    if shed is None:
                        break
                    shed.status = REJECTED
                    self.stats.queue_rejections += 1
                    self._trace_shed(shed, request, tracer)
                if self._queue.depth < (self.max_queue or 0):
                    self._queue.submit(request)
                    self.stats.admitted += 1
                    self.stats.queue_depth = self._queue.depth
                    self._trace_queued(request, tracer)
                    return request
            self.stats.queue_rejections += 1
            if tracer is not None:
                tracer.instant(
                    "queue_reject", tracer.lane("serving", "engine"),
                    {"request": request.request_id,
                     "depth": self._queue.depth},
                )
            raise
        self.stats.admitted += 1
        self.stats.queue_depth = self._queue.depth
        self._trace_queued(request, tracer)
        return request

    def _trace_shed(self, shed: Request, admitted: Request,
                    tracer) -> None:
        """A shed victim: engine-lane ``queue_shed``, its queue segment
        closed, a ``shed`` instant on its lane, the lane recycled."""
        if tracer is None:
            return
        tracer.instant("queue_shed", tracer.lane("serving", "engine"),
                       {"shed": shed.request_id,
                        "admitted": admitted.request_id})
        self._trace_close(shed, tracer, "queued", shed=True)
        lane = tracer.request_lane(shed.request_id, lease=False)
        if lane is not None:
            tracer.instant("shed", lane, {"request": shed.request_id,
                                          "replica": self.trace_name})
        tracer.release_request_lane(shed.request_id)

    def preempt(self, request_id: int,
                mode: Optional[str] = None) -> Request:
        """Evict a running request; it re-queues and resumes with its
        token stream intact.

        Slot engines preempt by recomputation only.  On a paged engine
        ``mode`` (or the engine's ``preempt_policy``) picks between
        **recompute** (the KV prefix is rebuilt by prefill on
        re-admission) and **swap** (page contents are copied to host
        memory under a checksum and scattered back into fresh pages on
        re-admission, no prefill).  ``"auto"`` chooses by resume cost
        (``paging.choose_preempt_mode``); a resume prefix that has
        outgrown every bucket forces swap.  A request still mid-prefill
        (chunked) preempts by recomputation only.
        """
        request = self._running.get(request_id)
        prefilling = False
        if request is None:
            request = self._prefilling.get(request_id)
            prefilling = request is not None
        if request is None:
            raise KeyError(f"request {request_id} is not running")
        if mode not in (None, "auto", "recompute", "swap"):
            # validate BEFORE any state is touched
            raise ValueError(
                f"preempt mode must be 'auto', 'recompute' or 'swap', "
                f"got {mode!r}"
            )
        if prefilling and mode == "swap":
            raise ValueError(
                "a mid-prefill request preempts by recomputation only"
            )
        resume_len = int(request.effective_prompt.size)
        if not self._paged:
            if mode not in (None, "recompute"):
                raise ValueError(
                    f"slot engines only preempt by recomputation, "
                    f"got mode={mode!r}"
                )
            # the resume prefix must fit a bucket BEFORE any state
            # changes: a failed preempt leaves the request running
            self.bucketer.bucket_for(resume_len)
            mode = "recompute"
        elif prefilling:
            # the re-queue needs a bucket; no tokens were generated yet
            self.bucketer.bucket_for(resume_len)
            mode = "recompute"
        else:
            try:
                self.bucketer.bucket_for(resume_len)
                fits = True
            except ValueError:
                fits = False
            if mode is None:
                mode = self.preempt_policy
            if mode == "auto":
                mode = choose_preempt_mode(
                    resume_len, len(self._pool.table(request_id)),
                    self.page_size, recompute_feasible=fits,
                )
            if mode == "recompute" and not fits:
                self.bucketer.bucket_for(resume_len)  # the diagnostic
        swap_record = None
        if mode == "swap":
            # host copies BEFORE any state mutates: a sentinel-padded
            # table keeps the copied shape fixed
            table = np.full(
                (self.max_pages_per_request,), self.num_pages, np.int32
            )
            held = self._pool.table(request_id)
            table[: len(held)] = held
            data = [st.swap_out(table) for st in self.stages]
            swap_record = dict(
                pages=len(held), index=request.index, data=data,
                nbytes=_swap_record_nbytes(data),
                checksum=_swap_record_checksum(len(held), request.index,
                                               data),
            )
        if prefilling:
            self._prefilling.pop(request_id)
            request.prefilled_len = 0  # recompute replays the tail
        else:
            self._running.pop(request_id)
        self._release_slot(request.slot)
        if self._paged:
            self._pool.release(request_id)
        request.slot = None
        request.preemptions += 1
        self.stats.preemptions += 1
        if swap_record is not None:
            self._swapped[request_id] = swap_record
            self.stats.swap_outs += 1
        tracer = get_tracer()
        self._trace_preempted(request, tracer, mode=mode)
        # force: a preempted request is already admitted.  A swapped
        # request needs no prefill bucket (its KV returns verbatim)
        self._queue.submit(request, force=True,
                           require_bucket=(mode != "swap"))
        self.stats.queue_depth = self._queue.depth
        self._trace_queued(request, tracer)
        return request

    def drain(self) -> List[Request]:
        """Evict everything and return it, token streams intact: every
        running request is preempted by recomputation and the queue
        emptied, FIFO order (swap records are local to this engine, so
        a drained request resumes elsewhere by re-prefilling).  A
        running request whose resume prefix fits no bucket stays
        running and is not returned."""
        for request_id in list(self._running) + list(self._prefilling):
            try:
                self.preempt(request_id, mode="recompute")
            except ValueError:
                continue  # not resumable by recompute: stays running
        drained = self._queue.drain()
        tracer = get_tracer()
        for r in drained:
            self._swapped.pop(r.request_id, None)
            # the queue segment ends on this engine; a re-submission
            # elsewhere opens a fresh one, so the migration gap shows
            self._trace_close(r, tracer, "queued", drained=True)
        self.stats.queue_depth = 0
        return drained

    def _finish(self, request: Request, now: float) -> None:
        self._release_slot(request.slot)
        if self._paged:
            # pages the radix index still references survive the
            # release — the prefix cache's retention, not a leak
            self._pool.release(request.request_id)
        request.slot = None
        request.status = FINISHED
        request.finished_s = now
        self._running.pop(request.request_id, None)
        self._finished.append(request)
        self.stats.finished += 1
        ttft = request.ttft_s()
        tpot = request.tpot_s()
        if ttft is not None:
            self.stats.ttft_s.append(ttft)
        if tpot is not None:
            self.stats.tpot_s.append(tpot)
        tracer = get_tracer()
        if tracer is not None:
            # terminal: close the decode segment, stamp the finish and
            # recycle the request's lane
            self._trace_close(request, tracer, "decode")
            lane = tracer.request_lane(request.request_id, lease=False)
            if lane is not None:
                tracer.instant(
                    "finish", lane,
                    {"request": request.request_id,
                     "replica": self.trace_name,
                     "tokens": len(request.tokens)},
                )
            tracer.release_request_lane(request.request_id)

    @property
    def finished_requests(self) -> List[Request]:
        return list(self._finished)

    def _health_snapshot(self) -> Dict[str, Any]:
        """The ``/healthz`` body (``LiveMetricsMixin.start_exporter``)."""
        snap = dict(
            status="ok",
            queue_depth=self._queue.depth,
            running=len(self._running),
            free_slots=self.free_slots,
            iterations=self.stats.iterations,
        )
        if self._paged:
            snap.update(
                kv_layout="paged",
                free_pages=self._pool.free_pages,
                pages_in_use=self._pool.pages_in_use,
                swapped=len(self._swapped),
                prefilling=len(self._prefilling),
                # which decode path a replica runs
                kv_dtype=self._pool.kv_dtype,
                attn_impl=self.attn_impl,
            )
        return snap

    # --- the continuous-batching loop ---------------------------------------
    def has_work(self) -> bool:
        return (bool(self._running) or bool(self._prefilling)
                or self._queue.depth > 0)

    def step(self) -> None:
        """One engine iteration: admit (prefill waves; paged: swap-ins or
        chunked enrollment), advance chunked prefill within its budget,
        then one decode tick — speculative when ``spec_k > 0`` — over
        every decode row."""
        if self._queue.depth > 0 and self.free_slots == 0:
            self.stats.queue_stalls += 1
            tracer = get_tracer()
            if tracer is not None:
                tracer.instant(
                    "queue_stall", tracer.lane("serving", "engine"),
                    {"queued": self._queue.depth},
                )
        if self._paged:
            self._admit_paged()
            if self._chunk_policy is not None:
                self._chunk_tick()
            if self.spec_k > 0 and self._draft is not None:
                self._spec_tick()
            else:
                self._decode_tick_paged()
        else:
            self._admit()
            self._decode_tick()
        self.stats.iterations += 1
        self.stats.queue_depth = self._queue.depth
        if self._paged:
            self.stats.batch_occupancy = self._rows.occupancy
            self._sync_paged_stats()
        else:
            self.stats.batch_occupancy = self.stages[0].pool.occupancy
        if self.timeseries is not None:
            self.timeseries.sample()
        if self.autotuner is not None:
            self.autotuner.on_step(self)

    def _sync_paged_stats(self) -> None:
        """Mirror the page pool's counters and gauges into
        ``ServingStats``; ``_pool_base`` banks the totals of pools a
        geometry reconfigure replaced, so no engine-lifetime counter
        goes backwards."""
        pool, base = self._pool, self._pool_base
        self.stats.prefix_hits = base["prefix_hits"] + pool.prefix_hits
        self.stats.prefix_tokens_reused = (
            base["prefix_tokens_reused"] + pool.prefix_tokens_reused)
        self.stats.cow_copies = base["cow_copies"] + pool.cow_copies
        self.stats.prefix_evictions = (
            base["prefix_evictions"] + pool.prefix_evictions)
        self.stats.pages_in_use = pool.pages_in_use
        self.stats.free_pages = pool.free_pages

    def run(self, requests: Optional[Sequence[Request]] = None,
            max_iterations: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive ``step`` until the queue and batch drain; returns
        ``{request_id: prompt + generated tokens}`` for everything that
        finished during the call."""
        finished0 = len(self._finished)
        for r in requests or ():
            self.submit(r)
        for _ in range(max_iterations):
            if not self.has_work():
                break
            self.step()
        else:  # pragma: no cover - scheduler liveness guard
            raise RuntimeError(
                f"serving engine made no full drain in "
                f"{max_iterations} iterations"
            )
        return {
            r.request_id: r.output() for r in self._finished[finished0:]
        }

    # --- the slot scheduling loop -------------------------------------------
    def _admit(self) -> None:
        if self.static_batching and self._running:
            return  # batch boundaries only: the naive baseline policy
        while True:
            wave = self._queue.next_wave(self.free_slots)
            if not wave:
                break
            self._prefill_wave(wave)

    def _prefill_wave(self, wave: List[Request]) -> None:
        """Prefill a same-bucket wave into freshly allocated slots, seat
        every member for decode and commit its first token."""
        bucket = wave[0].bucket
        rows = self.prefill_batch
        ids, lengths = self.bucketer.pad_batch(
            [r.effective_prompt for r in wave], bucket, rows, self.pad_id
        )
        slots = []
        for r in wave:
            slot = self._allocate_slot()
            if slot is None:  # next_wave is capped by free slots
                raise RuntimeError("prefill wave outgrew the free slots")
            r.slot = slot
            slots.append(slot)
        # rows past the wave carry the sentinel slot id: left out here,
        # their scatter drops
        dst = torch.as_tensor(slots, dtype=torch.long)
        src = torch.arange(len(wave))
        tracer = get_tracer()
        span0 = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        data = torch.from_numpy(ids)
        for st in self.stages:
            stage0 = tracer.now() if tracer is not None else 0.0
            data = st.prefill(data.to(st.device), dst.to(st.device),
                              src.to(st.device))
            self._trace_stage(tracer, st, "prefill", stage0,
                              {"bucket": bucket})
        logits = self._last_logits(data, lengths)
        tokens_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.stats.prefill_s += now - t0
        self.stats.prefill_waves += 1
        wave_tokens = int(lengths[: len(wave)].sum())
        self.stats.prefill_tokens += wave_tokens
        self._trace_wave(tracer, span0, "prefill", wave,
                         {"bucket": bucket, "wave": len(wave),
                          "tokens": wave_tokens}, admitted=True)

        sampled = self._sampled_rows(
            logits, [(i, r) for i, r in enumerate(wave)]
        )
        for i, r in enumerate(wave):
            r.tokens.append(self._pick_token(r, tokens_np[i], sampled.get(i)))
            r.index = int(lengths[i])
            r.status = RUNNING
            self._running[r.request_id] = r
            if r.first_token_s is None:
                r.first_token_s = now
            self.stats.generated_tokens += 1
            if r.done:
                self._finish(r, now)

    def _decode_tick(self) -> None:
        """One decode tick over every slot row: active rows at their own
        positions, free rows at position 0 (their write lands in a free
        row)."""
        active = list(self._running.values())
        if not active:
            return
        tokens = np.zeros((self.num_slots,), np.int64)
        index = np.zeros((self.num_slots,), np.int32)
        for r in active:
            tokens[r.slot] = r.tokens[-1]
            index[r.slot] = r.index
        tracer = get_tracer()
        span0 = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        data = torch.from_numpy(tokens[:, None])
        idx = torch.from_numpy(index)
        for st in self.stages:
            stage0 = tracer.now() if tracer is not None else 0.0
            data = st.decode(data.to(st.device), idx.to(st.device))
            self._trace_stage(tracer, st, "decode", stage0, None)
        logits = data[:, 0]  # [slots, V]
        nxt_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self._trace_wave(tracer, span0, "decode", active,
                         {"active": len(active)}, admitted=False)
        self.stats.decode_s += now - t0
        self.stats.decode_ticks += 1
        self.stats.decode_tokens += len(active)
        self.stats.generated_tokens += len(active)

        sampled = self._sampled_rows(logits, [(r.slot, r) for r in active])
        for r in active:
            r.tokens.append(
                self._pick_token(r, nxt_np[r.slot], sampled.get(r.slot))
            )
            r.index += 1
            if r.done:
                self._finish(r, now)

    # --- the paged scheduling loop ------------------------------------------
    def _admit_paged(self) -> None:
        """Admit from the queue while rows AND pages allow — admission
        charges each request its full page footprint.  FIFO: the head
        either admits (prefill wave, swap-in or chunked enrollment) or
        stalls the queue."""
        if self.static_batching and self._running:
            return  # batch boundaries only: the naive baseline policy
        while self._queue.requests and self._rows.free_slots >= 1:
            head = self._queue.requests[0]
            if head.request_id in self._swapped:
                if not self._swap_in(head):
                    if head.request_id in self._swapped:
                        self.stats.queue_stalls += 1  # pages unavailable
                        return
                    # corrupt record dropped (or the victim FAILED):
                    # re-judge the head as a recompute admission
                continue
            if self._chunk_policy is not None:
                # chunked admission is charge-only: the head gets its
                # grant and decode row, its prefill rides chunk waves
                if not self._enroll_chunked(head):
                    self.stats.queue_stalls += 1
                    return
                continue
            wave = self._select_paged_wave()
            if wave is None:
                self.stats.queue_stalls += 1  # rows were free, pages not
                return
            self._prefill_wave_paged(wave)

    def _enroll_chunked(self, request: Request) -> bool:
        """Admit the queue head under chunked prefill: charge its page
        grant, seat it on a decode row, apply the grant's COW copy and
        set the ``prefilled_len`` watermark at the shared-prefix
        boundary.  No prefill compute happens here.  False (nothing
        mutated) when the pages cannot be charged yet."""
        tokens = self._effective_tokens(request)
        grant = self._pool.acquire(
            request.request_id, tokens, len(tokens) + request.remaining
        )
        if grant is None:
            return False
        row = self._rows.allocate()
        if row is None:  # the caller checked free rows
            raise RuntimeError("chunked enrollment found no free row")
        request.slot = row
        self._apply_cow_plan(self._pool.cow_plan(grant))
        self._queue.remove(request)
        request.prefilled_len = grant.shared_tokens
        request.status = RUNNING
        self._prefilling[request.request_id] = request
        self.stats.queue_depth = self._queue.depth
        tracer = get_tracer()
        if tracer is not None:
            # the queue segment closes and the request's prefill segment
            # opens here; it spans enrollment -> final chunk
            now_us = tracer.now()
            tracer.instant(
                "admit", tracer.lane("serving", "engine"),
                {"request": request.request_id, "slot": request.slot,
                 "pages": len(grant.page_table),
                 "shared": grant.shared_tokens, "chunked": True},
            )
            self._trace_close(request, tracer, "queued", end_us=now_us)
            request.trace_marks["prefill"] = now_us
        return True

    def _chunk_tick(self) -> None:
        """Advance chunked prefill by at most the policy's budget:
        head-fixes-the-bucket chunk waves in enrollment order, each
        request advancing at most one chunk per tick.  A tick that
        leaves some mid-prefill request without a chunk counts one
        ``chunk_stalls``."""
        if not self._prefilling:
            return
        budget = self._chunk_policy.rows_for_tick(
            pending=len(self._prefilling), decoding=len(self._running)
        )
        advanced: set = set()
        while budget > 0:
            wave = self._select_chunk_wave(
                min(budget, self.prefill_batch), advanced
            )
            if not wave:
                break
            advanced.update(r.request_id for r in wave)
            self._chunk_wave(wave)
            budget -= len(wave)
        if any(rid not in advanced for rid in self._prefilling):
            self.stats.chunk_stalls += 1
            tracer = get_tracer()
            if tracer is not None:
                tracer.instant(
                    "chunk_stall", tracer.lane("serving", "engine"),
                    {"pending": len(self._prefilling)},
                )

    def _next_chunk_len(self, request: Request) -> int:
        return min(
            self.prefill_chunk,
            int(request.effective_prompt.size) - request.prefilled_len,
        )

    def _select_chunk_wave(self, cap: int,
                           exclude: set) -> List[Request]:
        """Up to ``cap`` mid-prefill requests whose next chunk pads to
        the enrollment head's bucket (FIFO head never skipped);
        ``exclude`` holds requests already advanced this tick."""
        pending = [
            r for r in self._prefilling.values()
            if r.request_id not in exclude
        ]
        if not pending:
            return []
        bucket = self.bucketer.bucket_for(self._next_chunk_len(pending[0]))
        wave: List[Request] = []
        for r in pending:
            if len(wave) >= cap:
                break
            if self.bucketer.bucket_for(self._next_chunk_len(r)) == bucket:
                wave.append(r)
        return wave

    def _chunk_wave(self, wave: List[Request]) -> None:
        """One prefill-chunk wave: each member's next ``<= prefill_chunk``
        prompt positions, padded to the wave bucket and written through
        the members' page tables at their ``prefilled_len`` watermarks.
        A member whose watermark reaches its prompt end commits its
        first token and joins the decode batch."""
        rows = self.prefill_batch
        chunks = []
        for r in wave:
            clen = self._next_chunk_len(r)
            chunks.append(
                r.effective_prompt[r.prefilled_len:r.prefilled_len + clen]
            )
        bucket = self.bucketer.bucket_for(int(chunks[0].size))
        ids, lengths = self.bucketer.pad_batch(
            chunks, bucket, rows, self.pad_id
        )
        tables = np.full(
            (rows, self.max_pages_per_request), self.num_pages, np.int32
        )
        index = np.zeros((rows,), np.int32)
        valid = np.zeros((rows,), np.int32)  # pad rows: writes drop
        for i, r in enumerate(wave):
            held = self._pool.table(r.request_id)
            tables[i, : len(held)] = held
            index[i] = r.prefilled_len
            valid[i] = r.prefilled_len + int(chunks[i].size)
        width = self._table_width(valid)
        self._count_quant(index, valid, width, len(wave))
        tracer = get_tracer()
        span0 = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        data = self._run_paged_stages(
            torch.from_numpy(ids).to(self.device), tables[:, :width],
            index, valid, tracer, "prefill",
            {"bucket": bucket, "chunk": True},
        )
        logits = self._last_logits(data, lengths)
        tokens_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.stats.prefill_s += now - t0
        self.stats.prefill_waves += 1
        chunk_tokens = int(sum(int(c.size) for c in chunks))
        self.stats.prefill_tokens += chunk_tokens
        self.stats.prefill_chunks += len(wave)
        end_us = self._trace_wave(
            tracer, span0, "prefill", wave,
            {"bucket": bucket, "wave": len(wave), "tokens": chunk_tokens,
             "chunked": True}, admitted=False)

        finals = [
            (i, r) for i, r in enumerate(wave)
            if r.prefilled_len + int(chunks[i].size)
            >= int(r.effective_prompt.size)
        ]
        sampled = self._sampled_rows(logits, finals)
        for i, r in enumerate(wave):
            r.prefilled_len += int(chunks[i].size)
            if r.prefilled_len < int(r.effective_prompt.size):
                continue  # watermark advanced; more chunks to come
            # final chunk: the last true position's logits seed the
            # first generated token, exactly like a one-shot wave
            self._prefilling.pop(r.request_id)
            if tracer is not None:
                self._trace_close(r, tracer, "prefill", end_us=end_us,
                                          chunked=True)
                r.trace_marks["decode"] = end_us
            self._pool.register_prefix(
                r.request_id, [int(t) for t in r.prompt]
            )
            r.tokens.append(self._pick_token(r, tokens_np[i], sampled.get(i)))
            r.index = r.prefilled_len
            r.prefilled_len = 0
            r.status = RUNNING
            self._running[r.request_id] = r
            if r.first_token_s is None:
                r.first_token_s = now
            self.stats.generated_tokens += 1
            if r.done:
                self._finish(r, now)

    @staticmethod
    def _effective_tokens(request: Request) -> tuple:
        """The request's effective prompt as a token tuple (the radix
        key), cached until its generated-token count changes."""
        n = len(request.tokens)
        cached = getattr(request, "_token_cache", None)
        if cached is not None and cached[0] == n:
            return cached[1]
        tokens = tuple(int(t) for t in request.effective_prompt)
        request._token_cache = (n, tokens)
        return tokens

    def _select_paged_wave(self) -> Optional[List[Any]]:
        """Dequeue the next prefill wave, or None when the head cannot be
        charged.  The head's TAIL bucket (prompt minus its radix-shared
        prefix) fixes the wave's shape; later queued requests whose tails
        land in the same bucket pack in, each charged its own grant."""
        queued = self._queue.requests
        head = queued[0]
        cap = min(self.prefill_batch, self._rows.free_slots)
        wave: List[Any] = []
        bucket: Optional[int] = None
        for r in queued:
            if len(wave) >= cap:
                break
            if r.request_id in self._swapped:
                continue  # swap-ins ride their own admission path
            tokens = self._effective_tokens(r)
            length = len(tokens)
            if bucket is not None:
                # cheap pre-screen before charging pages
                peek = self._pool.peek_shared(tokens)
                if self.bucketer.bucket_for(max(1, length - peek)) != bucket:
                    continue
            grant = self._pool.acquire(
                r.request_id, tokens, length + r.remaining
            )
            if grant is None:
                if r is head:
                    return None  # head starves -> the queue stalls
                break  # pages ran out mid-pack; serve what we have
            tail_bucket = self.bucketer.bucket_for(
                length - grant.shared_tokens
            )
            if bucket is None:
                bucket = tail_bucket
            elif tail_bucket != bucket:
                # the grant (made under eviction) disagreed with the
                # peek: hand the pages back and move on
                self._pool.rollback_grant(grant)
                continue
            wave.append((r, grant))
        if not wave:
            return None
        for r, _ in wave:
            self._queue.remove(r)
        return wave

    def _prefill_wave_paged(self, wave: List[Any]) -> None:
        """Prefill a wave of (request, grant) pairs: COW-clone partial
        shared pages, compute ONLY the non-shared tails, write their K/V
        through the page tables, and seat each request on a decode row."""
        rows = self.prefill_batch
        tails = [r.effective_prompt[g.shared_tokens:] for r, g in wave]
        bucket = self.bucketer.bucket_for(int(tails[0].size))
        ids, lengths = self.bucketer.pad_batch(
            tails, bucket, rows, self.pad_id
        )
        tables = np.full(
            (rows, self.max_pages_per_request), self.num_pages, np.int32
        )
        index = np.zeros((rows,), np.int32)
        valid = np.zeros((rows,), np.int32)  # pad rows: every write drops
        for i, (r, g) in enumerate(wave):
            row = self._rows.allocate()
            if row is None:  # the wave is capped by free rows
                raise RuntimeError("prefill wave outgrew the free rows")
            r.slot = row
            tables[i, : len(g.page_table)] = g.page_table
            index[i] = g.shared_tokens
            valid[i] = g.shared_tokens + int(tails[i].size)
        # copy-on-write BEFORE the step touches the slabs: the donor's
        # partial page becomes the sharer's private page, so the tail's
        # appends never write a shared page
        for _, g in wave:
            self._apply_cow_plan(self._pool.cow_plan(g))

        width = self._table_width(valid)
        self._count_quant(index, valid, width, len(wave))
        tracer = get_tracer()
        span0 = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        data = self._run_paged_stages(
            torch.from_numpy(ids).to(self.device), tables[:, :width],
            index, valid, tracer, "prefill", {"bucket": bucket},
        )
        logits = self._last_logits(data, lengths)  # [rows, V]
        tokens_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.stats.prefill_s += now - t0
        self.stats.prefill_waves += 1
        wave_tokens = int(sum(int(t.size) for t in tails))
        self.stats.prefill_tokens += wave_tokens
        self._trace_wave(tracer, span0, "prefill", [r for r, _ in wave],
                         {"bucket": bucket, "wave": len(wave),
                          "tokens": wave_tokens}, admitted=True)

        sampled = self._sampled_rows(
            logits, [(i, r) for i, (r, _) in enumerate(wave)]
        )
        for i, (r, g) in enumerate(wave):
            # index the radix cache BEFORE the done-check can release the
            # pages: a request that finishes in its prefill tick still
            # leaves its prompt warm for the next sharer
            self._pool.register_prefix(
                r.request_id, [int(t) for t in r.prompt]
            )
            r.tokens.append(self._pick_token(r, tokens_np[i], sampled.get(i)))
            r.index = int(valid[i])
            r.status = RUNNING
            self._running[r.request_id] = r
            if r.first_token_s is None:
                r.first_token_s = now
            self.stats.generated_tokens += 1
            if r.done:
                self._finish(r, now)

    def _table_width(self, valid) -> int:
        """Page-table columns this step needs: the wave's max live length
        ceiled to a page, then to the next power-of-two page count with
        the largest bucket's span as floor — attention walks O(live
        tokens), not O(max_pages).  ``gather_pages="full"``: the whole
        table, ``max_pages_per_request``, every step."""
        if self.gather_pages == "full":
            return self.max_pages_per_request
        need = max(1, pages_for(int(np.max(valid)), self.page_size))
        floor = pages_for(self.bucketer.max_bucket, self.page_size)
        width = max(need, floor)
        p = 1
        while p < width:
            p <<= 1
        return min(p, self.max_pages_per_request)

    def _count_quant(self, index, valid, width: int, rows: int) -> None:
        """int8 observability, per step: ``quantized_pages`` = pages the
        write touched (each re-quantized through its scale),
        ``dequant_blocks`` = page blocks attention dequantized (active
        rows x table width)."""
        if self.kv_dtype != "int8":
            return
        index = np.asarray(index)
        valid = np.asarray(valid)
        live = valid > index
        if np.any(live):
            touched = (
                (valid[live] - 1) // self.page_size
                - index[live] // self.page_size + 1
            )
            self.stats.quantized_pages += int(touched.sum())
        self.stats.dequant_blocks += int(rows) * int(width)

    def _apply_cow_plan(self, plan) -> None:
        """A grant's copy-on-write plan, on every stage's slabs."""
        if plan:
            for st in self.stages:
                st.apply_cow_plan(plan)

    def _run_paged_stages(self, data, tables, index, valid, tracer,
                          span_name, span_args=None):
        """Thread one paged step through every stage in order — the one
        dispatch idiom of prefill waves, chunk waves, decode ticks and
        the speculative verify.  The step's table, index and write plan
        are planned on the host once and moved once per distinct device
        (stages on one card share them); the hidden state moves only
        where the next stage's device differs (``.to`` is a no-op
        otherwise).  Each stage lays a ``span_name`` span on its lane.
        Returns the last stage's output."""
        slab = next((st.slabs[0][0] for st in self.stages if st.slabs),
                    None)
        inputs: Dict[torch.device, Any] = {}
        for st in self.stages:
            stage0 = tracer.now() if tracer is not None else 0.0
            if st.device not in inputs:
                inputs[st.device] = paged_step_inputs(
                    slab, tables, index, valid, data.shape[1], st.device)
            data = st.step(data.to(st.device), inputs[st.device])
            self._trace_stage(tracer, st, span_name, stage0, span_args)
        return data

    @staticmethod
    def _trace_stage(tracer, stage, name: str, stage0: float,
                     args: Optional[Dict[str, Any]]) -> None:
        """A ``name`` span on ``stage``'s lane from ``stage0`` (the
        host issuing the stage's work, as the reference's spans are);
        a no-op with tracing disabled."""
        if tracer is not None:
            tracer.complete(name, tracer.lane(stage.lane_name, "dispatch"),
                            stage0, args)

    def _last_logits(self, data, lengths):
        """Each row's logits at its last true position: [rows, V]."""
        dev = self._last_device
        last = torch.from_numpy(lengths.astype(np.int64) - 1).to(dev)
        return data[torch.arange(data.shape[0], device=dev), last]

    def _swap_in(self, request: Request) -> bool:
        """Re-seat a swapped-out request: fresh pages, host copies
        scattered back, NO prefill — decoding continues from exactly
        where the swap-out left it.  False (nothing mutated) when the
        pages cannot be charged yet.

        The record's checksum is verified first.  A mismatch drops the
        record (``swap_corruptions``) and returns False with the record
        gone, so the admission loop re-judges the head as a recompute
        re-admission; a victim whose resume prefix fits no bucket is
        FAILED instead."""
        record = self._swapped[request.request_id]
        if _swap_record_checksum(record["pages"], record["index"],
                                 record["data"]) != record["checksum"]:
            del self._swapped[request.request_id]
            self.stats.swap_corruptions += 1
            try:
                self.bucketer.bucket_for(int(request.effective_prompt.size))
            except ValueError:
                self._queue.remove(request)
                request.status = FAILED
                request.fail_reason = (
                    "swap record corrupted and the resume prefix fits "
                    "no bucket"
                )
                self.stats.queue_depth = self._queue.depth
            return False
        pages = self._pool.acquire_pages(request.request_id, record["pages"])
        if pages is None:
            return False
        row = self._rows.allocate()
        if row is None:  # the caller checked free rows
            raise RuntimeError("swap-in found no free row")
        table = np.full(
            (self.max_pages_per_request,), self.num_pages, np.int32
        )
        table[: len(pages)] = pages
        for st, host_pairs in zip(self.stages, record["data"]):
            st.swap_in(table, host_pairs)
        del self._swapped[request.request_id]
        self._queue.remove(request)
        request.slot = row
        request.index = record["index"]
        request.status = RUNNING
        self._running[request.request_id] = request
        self.stats.swap_ins += 1
        self.stats.queue_depth = self._queue.depth
        tracer = get_tracer()
        if tracer is not None:
            now_us = tracer.now()
            tracer.instant("swap_in", tracer.lane("serving", "engine"),
                           {"request": request.request_id,
                            "pages": record["pages"]})
            self._trace_close(request, tracer, "queued", swapped_in=True)
            request.trace_marks["decode"] = now_us
        return True

    def _decode_rows(self, active):
        """Per-row host inputs of a decode tick over ``active``: last
        tokens [rows], positions [rows] and page tables [rows, max_pages]
        (inactive rows: token 0, index 0, all sentinels)."""
        rows = self.max_concurrency
        tokens = np.zeros((rows,), np.int64)
        index = np.zeros((rows,), np.int32)
        tables = np.full(
            (rows, self.max_pages_per_request), self.num_pages, np.int32
        )
        for r in active:
            tokens[r.slot] = r.tokens[-1]
            index[r.slot] = r.index
            held = self._pool.table(r.request_id)
            tables[r.slot, : len(held)] = held
        return tokens, index, tables

    def _decode_tick_paged(self) -> None:
        active = list(self._running.values())
        if not active:
            return
        tokens, index, tables = self._decode_rows(active)
        valid = np.zeros_like(index)  # inactive rows never write
        for r in active:
            valid[r.slot] = r.index + 1

        width = self._table_width(valid)
        self._count_quant(index, valid, width, len(active))
        tracer = get_tracer()
        span0 = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        data = self._run_paged_stages(
            torch.from_numpy(tokens[:, None]).to(self.device),
            tables[:, :width], index, valid, tracer, "decode",
        )
        logits = data[:, 0]  # [rows, V]
        nxt_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self._trace_wave(tracer, span0, "decode", active,
                         {"active": len(active), "width": width},
                         admitted=False)
        self.stats.decode_s += now - t0
        self.stats.decode_ticks += 1
        self.stats.decode_tokens += len(active)
        self.stats.generated_tokens += len(active)

        sampled = self._sampled_rows(logits, [(r.slot, r) for r in active])
        for r in active:
            r.tokens.append(
                self._pick_token(r, nxt_np[r.slot], sampled.get(r.slot))
            )
            r.index += 1
            if r.done:
                self._finish(r, now)

    def _spec_tick(self) -> None:
        """One speculative decode tick: the draft proposes ``spec_k``
        tokens per row (``Lq = 1`` steps over the stage's first
        ``draft_blocks`` slab pairs), then the target verifies all
        ``spec_k + 1`` positions in ONE forward (``Lq = spec_k + 1``) and
        greedy acceptance commits the agreed draft prefix plus the
        target's own next token — so the committed stream is the
        non-speculative greedy stream.  Rollback is a watermark
        truncate: rejected positions' KV sits past the committed
        ``index``.  Temperature rows commit one token from the verify's
        position-0 logits; a tick with no greedy row is a plain decode
        tick."""
        active = list(self._running.values())
        if not active:
            return
        if all(r.temperature > 0.0 for r in active):
            self._decode_tick_paged()
            return
        k = self.spec_k
        tokens, index0, tables = self._decode_rows(active)
        reserve = np.zeros_like(index0)  # inactive rows: 0 -> writes drop
        for r in active:
            reserve[r.slot] = int(r.prompt.size) + r.max_new_tokens
        # verify writes cap at min(index + k + 1, reserve); one table
        # width (covering that bound) serves the draft and the verify
        valid = np.minimum(index0 + k + 1, reserve)
        width = self._table_width(valid)
        tables = tables[:, :width]
        self._count_quant(index0, valid, width, len(active))
        if self.kv_dtype == "int8":
            # the draft's k Lq=1 passes quantize (one tail-page re-quant
            # per kept step per row) and dequantize (one table width per
            # step) too
            slots = [r.slot for r in active]
            kept = np.clip(reserve[slots] - index0[slots], 0, k)
            self.stats.quantized_pages += int(kept.sum())
            self.stats.dequant_blocks += k * len(active) * width
        tracer = get_tracer()
        span0 = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        d = self._draft.num_attn
        drafted = self._draft.draft_k(
            torch.from_numpy(tokens).to(self.device),
            self.stages[0].slabs[:d], tables, index0, reserve, k,
        )
        verify_in = np.concatenate([tokens[:, None], drafted], axis=1)
        logits3 = self._run_paged_stages(
            torch.from_numpy(verify_in).to(self.device), tables, index0,
            valid, tracer, "decode",
        )  # [rows, k+1, V]
        target_np = logits3.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self._trace_wave(tracer, span0, "decode", active,
                         {"active": len(active), "spec_k": k},
                         admitted=False)
        self.stats.decode_s += now - t0
        self.stats.spec_ticks += 1

        sampled = self._sampled_rows(
            logits3[:, 0], [(r.slot, r) for r in active]
        )
        committed_total = 0
        for r in active:
            row = r.slot
            if r.temperature > 0.0:
                # position-0 logits == the plain decode tick's logits
                tok = self._pick_token(r, target_np[row, 0],
                                       sampled.get(row))
                commit = [tok][: min(1, r.remaining)]
            else:
                remaining = r.remaining
                accepted = greedy_accept_count(drafted[row],
                                               target_np[row, :k])
                commit = (
                    [int(t) for t in drafted[row, :accepted]]
                    + [int(target_np[row, accepted])]
                )
                ncommit = min(len(commit), remaining)
                commit = commit[:ncommit]
                # only USABLE proposals count: a row whose remaining
                # budget is below k could never consume the surplus
                self.stats.draft_tokens += min(k, remaining)
                self.stats.accepted_draft_tokens += min(accepted, ncommit)
                # the verify wrote min(k+1, remaining) positions; a
                # rollback happened iff the watermark stops short of that
                if ncommit < min(k + 1, remaining):
                    self.stats.spec_rollbacks += 1
            r.tokens.extend(commit)
            r.index += len(commit)
            committed_total += len(commit)
            if r.done:
                self._finish(r, now)
        self.stats.decode_tokens += committed_total
        self.stats.generated_tokens += committed_total

    @staticmethod
    def _sampled_rows(logits, rows) -> Dict[int, np.ndarray]:
        """Host copies of ONLY the logits rows temperature sampling
        needs (``rows`` is (row index, request) pairs); greedy requests
        cost no device-to-host copy of logits."""
        need = [i for i, r in rows if r.temperature > 0.0]
        if not need:
            return {}
        pulled = logits[torch.as_tensor(need, device=logits.device)]
        return dict(zip(need, pulled.float().cpu().numpy()))

    def _pick_token(self, request: Request, greedy_tok, logits_row) -> int:
        """Greedy by default; temperature sampling draws from a
        request-local ``torch.Generator`` seeded from (seed, position),
        so interleaving with other requests never perturbs it."""
        if request.temperature <= 0.0:
            return int(greedy_tok)
        position = int(request.prompt.size) + len(request.tokens)
        seed = int(np.random.SeedSequence(
            [int(request.seed), position]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        probs = torch.softmax(
            torch.from_numpy(np.asarray(logits_row, np.float32))
            / request.temperature, dim=-1,
        )
        return int(torch.multinomial(probs, 1, generator=gen)[0])


__all__ = ["ServingEngine", "ServingStats"]
