"""Shape-bucketing admission layer for the serving engine.

Serving traffic has arbitrary prompt lengths; XLA programs have fixed
shapes.  The bridge is a small set of **prompt-length buckets**: every
prompt is right-padded to the smallest bucket that holds it, so the
prefill program compiles once per bucket and the steady-state decode
program (always ``[slots, 1]``) compiles exactly once — the SKY002
recompile discipline applied to serving.  Bucket choice trades padding
waste (few, large buckets) against warmup compiles (many buckets);
padding positions are attention-masked so they never change a token.

Admission is FIFO with same-bucket packing: the head of the queue picks
the bucket, and up to ``prefill_batch`` queued requests of that same
bucket join it (skipping over other buckets WITHOUT starving them — the
head request itself is always served first).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# request lifecycle states
QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
# terminal non-success states (set by admission control / the fleet):
# REJECTED = refused or shed by a bounded queue / load-shedding policy,
# FAILED = lost to an unrecoverable replica failure (a request whose
# resume prefix outgrew every bucket on a dead engine) — both always
# counted, never silent
REJECTED = "rejected"
FAILED = "failed"

_REQUEST_IDS = itertools.count()


class QueueFullError(RuntimeError):
    """A bounded :class:`AdmissionQueue` refused a new submission.

    Carries ``queue_depth`` (the bound it hit) so callers can build an
    honest backpressure hint (Retry-After-style) instead of guessing.
    """

    def __init__(self, message: str, queue_depth: int = 0):
        super().__init__(message)
        self.queue_depth = int(queue_depth)


@dataclass
class Request:
    """One generation request and its runtime state.

    ``prompt`` is the token ids; ``tokens`` accumulates generated ids as
    the engine produces them (the per-request output stream).  After a
    preemption the request re-enters the queue and its *effective*
    prompt is ``prompt + tokens`` — decoding resumes by recomputing the
    KV prefix (vLLM-style recomputation preemption), so the token
    stream is preserved exactly.
    """

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    request_id: int = field(default_factory=lambda: next(_REQUEST_IDS))

    # runtime state (owned by the engine)
    status: str = QUEUED
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    index: int = 0               # current sequence length in the cache
    bucket: Optional[int] = None
    preemptions: int = 0
    # chunked-prefill watermark (paged engine, prefill_chunk set):
    # prompt positions whose KV is already resident.  A request admitted
    # under chunking holds its page grant and a decode row while
    # prefilled_len < len(effective_prompt); each engine tick advances
    # the watermark by at most one chunk, interleaved with decode ticks.
    # 0 means "not mid-prefill" (the one-shot wave path never sets it,
    # and preemption resets it — recomputation replays the whole tail).
    prefilled_len: int = 0

    # the reasoned verdict for a FAILED terminal state (set by whoever
    # fails the request — fleet migration, swap-corruption fallback):
    # "every request terminal with a reason" is an auditable invariant
    # only if the reason rides on the request itself
    fail_reason: Optional[str] = None

    # SLO stamps (perf_counter seconds; None until reached)
    submitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None

    # request-scoped tracing scratch (tracer-relative µs marks for the
    # segment currently open on this request's trace lane).  Lives ON
    # the request because the request object is the one thing that
    # survives preemption and cross-replica migration — whoever closes
    # a segment (engine finish/preempt, fleet dead-drain) finds the
    # open mark here.  Empty dict and never touched while tracing is
    # disabled.
    trace_marks: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )

    @property
    def effective_prompt(self) -> np.ndarray:
        """Prompt plus already-generated tokens (the resume prefix)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)]
        )

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    def output(self) -> np.ndarray:
        """prompt + generated tokens (the ``generate`` output layout)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)]
        )

    def ttft_s(self) -> Optional[float]:
        if self.submitted_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.submitted_s

    def tpot_s(self) -> Optional[float]:
        """Mean per-output-token latency after the first token, or None
        when undefined (unfinished, or a single-token generation — a
        0.0 here would drag the fleet TPOT percentiles toward zero)."""
        if self.first_token_s is None or self.finished_s is None:
            return None
        n = len(self.tokens)
        if n <= 1:
            return None
        return (self.finished_s - self.first_token_s) / (n - 1)


class ShapeBucketer:
    """Prompt lengths -> the fixed bucket set the programs compile for."""

    def __init__(self, buckets: Sequence[int]):
        cleaned = sorted(set(int(b) for b in buckets))
        if not cleaned or cleaned[0] < 1:
            raise ValueError(f"invalid bucket set {list(buckets)!r}")
        self.buckets: Tuple[int, ...] = tuple(cleaned)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, length: int) -> int:
        """Smallest bucket >= length (the pad target for a prompt)."""
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket "
            f"{self.buckets[-1]}; add a bucket or truncate"
        )

    def pad_batch(
        self, prompts: Sequence[np.ndarray], bucket: int, rows: int,
        pad_id: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Right-pad ``prompts`` to [rows, bucket] + true-length vector.

        Rows beyond ``len(prompts)`` are all-pad dummies (the admission
        batch itself is a fixed shape, so a half-full admission wave
        reuses the compiled prefill program).  Dummy lengths read 1 so a
        gather at ``length - 1`` stays in range.
        """
        ids = np.full((rows, bucket), pad_id, np.int32)
        lengths = np.ones((rows,), np.int32)
        for i, p in enumerate(prompts):
            p = np.asarray(p, np.int32).reshape(-1)
            if p.size > bucket:
                raise ValueError(
                    f"prompt of length {p.size} does not fit bucket "
                    f"{bucket}"
                )
            ids[i, : p.size] = p
            lengths[i] = p.size
        return ids, lengths


class AdmissionQueue:
    """FIFO queue with same-bucket packing for prefill waves.

    ``max_queue`` bounds the depth: a full queue REJECTS new submissions
    with :class:`QueueFullError` instead of growing without bound (an
    unbounded admission queue under a traffic spike is an OOM with extra
    steps).  The bound applies to NEW admissions only — re-queues that
    preserve an already-admitted request's token stream (preemption,
    reconfiguration, fleet migration) pass ``force=True`` and always
    land, because dropping one of those silently loses committed tokens.
    """

    def __init__(self, bucketer: ShapeBucketer, prefill_batch: int = 1,
                 max_queue: Optional[int] = None):
        if prefill_batch < 1:
            raise ValueError(
                f"prefill_batch must be >= 1, got {prefill_batch}"
            )
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.bucketer = bucketer
        self.prefill_batch = int(prefill_batch)
        self.max_queue = None if max_queue is None else int(max_queue)
        self._queue: List[Request] = []

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def depth(self) -> int:
        return len(self._queue)

    def submit(self, request: Request, force: bool = False,
               require_bucket: bool = True) -> None:
        # bucket validation FIRST (its ValueError is the older contract
        # and callers match on it), capacity second, state mutation last
        # — a rejected request keeps its pre-submit state.
        # ``require_bucket=False`` is the paged engine's swap re-queue:
        # a swapped request resumes from host page copies with NO
        # prefill, so it needs no bucket — exactly how swap serves
        # resume prefixes that have outgrown every bucket.
        bucket = (
            self.bucketer.bucket_for(int(request.effective_prompt.size))
            if require_bucket else None
        )
        if (not force and self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            raise QueueFullError(
                f"admission queue full ({len(self._queue)}/"
                f"{self.max_queue}); request {request.request_id} "
                f"rejected", queue_depth=len(self._queue),
            )
        if request.submitted_s is None:
            request.submitted_s = time.perf_counter()
        request.status = QUEUED
        request.bucket = bucket
        self._queue.append(request)

    def remove(self, request: Request) -> None:
        """Remove a specific queued request (the paged engine's wave
        selection dequeues its own members — tail buckets are computed
        against the live prefix cache, not the submit-time prompt).
        Identity-based: ``Request`` is a dataclass over numpy arrays,
        so ``==`` would compare prompt contents elementwise."""
        for i, r in enumerate(self._queue):
            if r is request:
                del self._queue[i]
                return
        raise ValueError(
            f"request {request.request_id} is not queued"
        )

    def shed_oldest(self) -> Optional[Request]:
        """Remove and return the oldest SHEDDABLE queued request (the
        shed policy's victim: under overload the head of the queue has
        waited longest and is the most likely to have already blown its
        deadline), or None when nothing can be shed.  A request with
        committed tokens (a preempted/migrated resume, force-queued) is
        never a victim — shedding it would lose its generated stream,
        the exact outcome ``force`` exists to prevent — and neither is
        a preempted/migrated request still waiting for its first token
        (``preemptions > 0``): its admission promise was already made
        once and must not be revoked to seat a newcomer.  The caller
        owns marking the victim ``REJECTED`` and counting the shed."""
        for i, r in enumerate(self._queue):
            if not r.tokens and r.preemptions == 0:
                return self._queue.pop(i)
        return None

    @property
    def requests(self) -> Tuple[Request, ...]:
        """Queued requests, FIFO order (read-only view)."""
        return tuple(self._queue)

    def drain(self) -> List[Request]:
        """Remove and return every queued request, FIFO order.

        Used by ``ServingEngine.reconfigure``: an operating-point change
        rebuilds the queue around a new bucketer, so the old queue's
        contents re-submit (re-bucket) into the new one.
        """
        drained, self._queue = self._queue, []
        return drained

    def next_wave(self, free_slots: int) -> Optional[List[Request]]:
        """Dequeue the next same-bucket prefill wave, or None.

        The queue head fixes the bucket (FIFO — no starvation); later
        same-bucket requests pack into the wave up to
        ``min(prefill_batch, free_slots)``.
        """
        if not self._queue or free_slots < 1:
            return None
        head_bucket = self._queue[0].bucket
        cap = min(self.prefill_batch, free_slots)
        wave: List[Request] = []
        rest: List[Request] = []
        for r in self._queue:
            if len(wave) < cap and r.bucket == head_bucket:
                wave.append(r)
            else:
                rest.append(r)
        self._queue = rest
        return wave


__all__ = [
    "AdmissionQueue",
    "FAILED",
    "FINISHED",
    "QUEUED",
    "QueueFullError",
    "REJECTED",
    "RUNNING",
    "Request",
    "ShapeBucketer",
]
