"""ServingEngine: iteration-level continuous batching over a paged KV pool.

The port of ``skycomputing_tpu/serving/engine.py``'s paged layout on one
stage and one device.  Every tick the engine (1) admits queued requests
through bucketed prefill waves while decode rows AND pages allow, and
(2) runs one single-token decode step over all decode rows.  Requests
join and leave the running batch only between ticks (Orca, OSDI '22).

KV lives in per-layer page pools ``[num_pages, page_size, heads,
head_dim]`` addressed through per-request page tables; the host
bookkeeping — free-list allocator, refcounts, radix prefix cache,
copy-on-write grants — is :mod:`.paging`, a verbatim copy of the JAX
package's.  Prefill and decode are one function (``models/gpt.
apply_kv_paged``) at two shapes, and both go through the paged-attention
kernel (``ops/paged_attention.py``) on the card.

PyTorch runs eagerly, so there are no compiled programs to key, donate
or warm: the page slabs are updated in place and the bucket set only
bounds prefill padding.  Inactive decode rows still ride through each
step (``index = 0``, ``valid = 0``, all-sentinel tables): their writes
drop and their attention reads stay inside the pool.

Not ported yet, and raising ``NotImplementedError`` when asked for: the
slot layout, chunked prefill (``prefill_chunk``), speculative decoding
(``spec_k``), int8 pages (``kv_dtype``), multi-stage placement
(``worker_manager``/``partition``), swap/recompute preemption,
``reconfigure``, handoff export/import, and the live-metrics exporter.
There is no tracer and no autotuner hook.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..builder import build_layer_stack
from ..models.gpt import (
    GptEmbeddings,
    _gcfg,
    apply_kv_paged,
    attn_indices,
    decode_modules,
)
from ..utils import resolve_device
from .batcher import (
    AdmissionQueue,
    FINISHED,
    QueueFullError,
    REJECTED,
    RUNNING,
    Request,
    ShapeBucketer,
)
from .kv_cache import init_paged_caches, kv_spec_from_config
from .paging import PagedKVCachePool, RowAllocator, pages_for


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
    """

    iterations: int = 0
    prefill_waves: int = 0
    prefill_tokens: int = 0
    decode_ticks: int = 0
    decode_tokens: int = 0
    generated_tokens: int = 0
    admitted: int = 0
    finished: int = 0
    queue_stalls: int = 0
    queue_rejections: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    cow_copies: int = 0
    prefix_evictions: int = 0
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
    """The one stage: module slice + device + per-attention-layer page
    slabs ``[num_pages, page_size, heads, head_dim]``."""

    def __init__(self, modules: Sequence[Any], state_dicts: Sequence[Any],
                 device: torch.device, num_pages: int, page_size: int):
        self.device = device
        for module, sd in zip(modules, state_dicts):
            module.load_state_dict(sd, strict=True)
        self.modules = [m.to(device) for m in modules]
        self.specs = [
            kv_spec_from_config(self.modules[i].config.to_dict(), page_size)
            for i in attn_indices(self.modules)
        ]
        self.slabs = self.build_slabs(num_pages, page_size)

    def build_slabs(self, num_pages: int, page_size: int):
        """Fresh zeroed page slabs, one (k, v) pair per attention layer."""
        return init_paged_caches(self.specs, num_pages, page_size,
                                 device=self.device)

    def apply_cow_plan(self, plan) -> None:
        """Execute the pool's copy-on-write plan
        (``PagedKVCachePool.cow_plan``) on every layer's slabs, in
        place.  A scale copy means the pool believes its pages are int8
        while these slabs are not — pool/stage drift, which raises."""
        for kind, src, dst in plan:
            if kind != "values":
                raise ValueError(
                    f"COW plan entry {kind!r} does not apply to fp slabs"
                )
            for k, v in self.slabs:
                k[dst].copy_(k[src])
                v[dst].copy_(v[src])

    def step(self, data, tables, index, valid):
        """One paged step through every module; returns the output."""
        out, self.slabs = apply_kv_paged(
            self.modules, data, self.slabs, tables, index, valid
        )
        return out


def _not_ported(feature: str):
    raise NotImplementedError(
        f"{feature} is not ported to the PyTorch serving engine yet"
    )


class ServingEngine:
    """Continuous-batching GPT serving over a paged KV pool, one stage
    on one device.

    ``model_cfg`` is the layer-config list (``gpt_layer_configs``
    output, the same dicts the JAX package builds); ``params_list`` the
    matching per-layer state dicts (``convert.params_from_jax`` or
    ``models.gpt.random_state_dicts``).  ``device`` defaults to CUDA;
    without a CUDA device construction raises unless the caller passes
    ``device="cpu"``.
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
        kv_layout: str = "paged",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        max_pages_per_request: Optional[int] = None,
        max_concurrency: Optional[int] = None,
        enable_prefix_cache: bool = True,
        max_prefix_entries: int = 256,
        device=None,
        prefill_chunk: Optional[int] = None,
        spec_k: int = 0,
        kv_dtype: Optional[str] = None,
        worker_manager=None,
        partition: Optional[Sequence[int]] = None,
    ):
        if kv_layout == "slot":
            _not_ported("the slot KV layout")
        if kv_layout != "paged":
            raise ValueError(f"kv_layout must be 'paged', got {kv_layout!r}")
        if prefill_chunk:
            _not_ported("chunked prefill (prefill_chunk)")
        if spec_k:
            _not_ported("speculative decoding (spec_k)")
        if kv_dtype is not None:
            _not_ported(f"kv_dtype={kv_dtype!r} pages")
        if worker_manager is not None or (
                partition is not None and len(partition) > 1):
            _not_ported("multi-stage placement")
        if queue_policy not in ("reject", "shed"):
            raise ValueError(
                f"queue_policy must be 'reject' or 'shed', "
                f"got {queue_policy!r}"
            )
        self.device = resolve_device(device)
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
        # the paged operating point: max_len becomes the PER-REQUEST
        # virtual span (max_pages_per_request x page_size), and the pool
        # depth decouples from it — num_pages defaults to num_slots
        # requests of max_len each
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_pages_per_request is not None:
            self.max_pages_per_request = int(max_pages_per_request)
        else:
            # cover max_len, but never round the span past the model's
            # position table
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
                f"max_concurrency must be >= 1, got {self.max_concurrency}"
            )
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
        # decode rows are the concurrency lanes ("slots")
        self.num_slots = self.max_concurrency
        self.max_len = int(max_len)
        self.pad_id = int(pad_id)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queue_policy = queue_policy
        self.prefill_batch = int(prefill_batch)
        self._queue = AdmissionQueue(
            self.bucketer, prefill_batch=prefill_batch,
            max_queue=self.max_queue,
        )
        self.stats = ServingStats()
        self._running: Dict[int, Request] = {}
        self._finished: List[Request] = []
        self._pool = PagedKVCachePool(
            self.num_pages, self.page_size, self.max_pages_per_request,
            enable_prefix_cache=bool(enable_prefix_cache),
            max_prefix_entries=int(max_prefix_entries),
            kv_dtype=str(_gcfg(modules[0].config).dtype),
        )
        self._rows = RowAllocator(self.max_concurrency)
        self.stage = _PagedServingStage(
            modules, list(params_list), self.device, self.num_pages,
            self.page_size,
        )

    # --- features of the JAX engine this port does not have yet ------------
    def preempt(self, request_id: int, mode: Optional[str] = None):
        _not_ported("preemption (swap/recompute)")

    def reconfigure(self, **knobs):
        _not_ported("reconfigure")

    def export_handoff(self, request_id: int):
        _not_ported("KV handoff export")

    def import_handoff(self, request: Request, record: dict):
        _not_ported("KV handoff import")

    def enable_timeseries(self, *args, **kwargs):
        _not_ported("the live-metrics time series")

    def start_exporter(self, *args, **kwargs):
        _not_ported("the live-metrics exporter")

    # --- request lifecycle --------------------------------------------------
    @property
    def free_slots(self) -> int:
        return self._rows.free_slots

    @property
    def queued_requests(self) -> List[Request]:
        return list(self._queue.requests)

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
                if self._queue.depth < (self.max_queue or 0):
                    self._queue.submit(request)
                    self.stats.admitted += 1
                    self.stats.queue_depth = self._queue.depth
                    return request
            self.stats.queue_rejections += 1
            raise
        self.stats.admitted += 1
        self.stats.queue_depth = self._queue.depth
        return request

    def _finish(self, request: Request, now: float) -> None:
        self._rows.release(request.slot)
        # pages the radix index still references survive the release —
        # the prefix cache's retention, not a leak
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

    # --- the continuous-batching loop ---------------------------------------
    def has_work(self) -> bool:
        return bool(self._running) or self._queue.depth > 0

    def step(self) -> None:
        """One engine iteration: admit prefill waves, then one decode
        tick over every decode row."""
        if self._queue.depth > 0 and self.free_slots == 0:
            self.stats.queue_stalls += 1
        self._admit_paged()
        self._decode_tick_paged()
        self.stats.iterations += 1
        self.stats.queue_depth = self._queue.depth
        self.stats.batch_occupancy = self._rows.occupancy
        pool = self._pool
        self.stats.prefix_hits = pool.prefix_hits
        self.stats.prefix_tokens_reused = pool.prefix_tokens_reused
        self.stats.cow_copies = pool.cow_copies
        self.stats.prefix_evictions = pool.prefix_evictions
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

    # --- the paged scheduling loop ------------------------------------------
    def _admit_paged(self) -> None:
        """Admit from the queue while rows AND pages allow — admission
        charges each request its full page footprint.  FIFO: the head
        either admits or stalls the queue."""
        while self._queue.requests and self._rows.free_slots >= 1:
            wave = self._select_paged_wave()
            if wave is None:
                self.stats.queue_stalls += 1  # rows were free, pages not
                return
            self._prefill_wave_paged(wave)

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
            plan = self._pool.cow_plan(g)
            if plan:
                self.stage.apply_cow_plan(plan)

        width = self._table_width(valid)
        t0 = time.perf_counter()
        data = self.stage.step(
            torch.from_numpy(ids).to(self.device), tables[:, :width],
            index, valid,
        )
        last = torch.from_numpy(lengths.astype(np.int64) - 1).to(self.device)
        logits = data[torch.arange(rows, device=self.device), last]  # [rows, V]
        tokens_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.stats.prefill_s += now - t0
        self.stats.prefill_waves += 1
        self.stats.prefill_tokens += int(sum(int(t.size) for t in tails))

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
        tokens), not O(max_pages)."""
        need = max(1, pages_for(int(np.max(valid)), self.page_size))
        floor = pages_for(self.bucketer.max_bucket, self.page_size)
        width = max(need, floor)
        p = 1
        while p < width:
            p <<= 1
        return min(p, self.max_pages_per_request)

    def _decode_tick_paged(self) -> None:
        active = list(self._running.values())
        if not active:
            return
        rows = self.max_concurrency
        tokens = np.zeros((rows, 1), np.int64)
        index = np.zeros((rows,), np.int32)
        valid = np.zeros((rows,), np.int32)  # inactive rows never write
        tables = np.full(
            (rows, self.max_pages_per_request), self.num_pages, np.int32
        )
        for r in active:
            tokens[r.slot, 0] = r.tokens[-1]
            index[r.slot] = r.index
            valid[r.slot] = r.index + 1
            held = self._pool.table(r.request_id)
            tables[r.slot, : len(held)] = held

        width = self._table_width(valid)
        t0 = time.perf_counter()
        data = self.stage.step(
            torch.from_numpy(tokens).to(self.device), tables[:, :width],
            index, valid,
        )
        logits = data[:, 0]  # [rows, V]
        nxt_np = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
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
