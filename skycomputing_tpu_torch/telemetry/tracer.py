"""Low-overhead span tracer with Chrome Trace Event export (the port's
own copy of ``skycomputing_tpu/telemetry/tracer.py``; pure stdlib).

``PipelineStats`` carries one dispatch/wait split per step; this tracer
records the per-event timeline behind it (PipeDream's per-stage
occupancy method) and exports it in **Chrome Trace Event Format** JSON,
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Design constraints, in order:

- **hard-disabled = zero cost**: tracing defaults OFF; the process-global
  accessor :func:`get_tracer` returns ``None`` and every instrumentation
  site is a single ``is None`` test away from the uninstrumented path.
  The module-level :func:`trace_span` helper returns one shared no-op
  singleton when disabled — no object allocation, no clock read.
- **low overhead enabled**: events are plain tuples appended to a
  bounded ``deque`` ring buffer (oldest events drop when full, counted
  in :attr:`Tracer.dropped`); dict materialization and lane metadata
  happen at export time, never on the hot path.  One ``monotonic()``
  read per instant, two per span.
- **thread-safe**: appends ride CPython's atomic ``deque.append``; the
  lane registry (the only shared mutable dict) takes a lock on first
  registration of a lane and is read lock-free afterwards.

Lane model: a lane is a ``(process, thread)`` name pair mapped to the
Chrome ``pid``/``tid`` integers.  Convention used by the instrumented
modules (and assumed by :mod:`.analysis`):

- ``("stage {k} [{device}]", "dispatch")`` — one process row per
  pipeline stage, microbatch ``fwd``/``bwd`` and ``update`` spans;
- ``("runner", "iterations")`` — ``iter`` spans from ``TraceHook``;
- ``("runner", "lifecycle")`` — run markers, ``preflight``,
  ``checkpoint`` and ``eval`` spans;
- ``("host", "dispatch")`` — one ``host_dispatch`` span per train step;
- ``("transfers", ...)``, ``("dynamics", ...)``, ``("selfheal", ...)``
  — transfer instants, allocator/benchmark phases, and the async
  self-heal arc.

Timestamps are microseconds on a monotonic clock, relative to tracer
construction.  Durations are clamped non-negative so a misbehaving
injected clock can never emit an event Perfetto refuses to nest.  A span
times the host: on the card it closes when the host has issued its
work, not when the card has done it (nothing here synchronizes).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

Lane = Tuple[int, int]

_DEFAULT_CAPACITY = 1 << 16


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_lane", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, lane: Lane,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._lane = lane
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.complete(self._name, self._lane, self._t0, self._args)
        return False


class _NullSpan:
    """The disabled-tracing span: one shared instance, allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered span/instant/async/counter event recorder.

    ``capacity`` bounds memory: the buffer holds the newest ``capacity``
    events and :attr:`dropped` counts evictions, so a runaway trace can
    never OOM the host (it truncates its own history instead).  ``clock``
    is injectable for tests (fake clocks); production uses
    ``time.monotonic`` — wall-clock steps (NTP slew) must never produce
    negative spans.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.monotonic,
                 request_lanes: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._epoch = clock()
        # event tuples: (ph, name, ts_us, dur_us, pid, tid, args, async_id)
        self._events: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        # RLock: request_lane() registers through lane() under the lock
        self._lock = threading.RLock()
        self._lanes: Dict[Tuple[str, str], Lane] = {}
        self._pids: Dict[str, int] = {}
        self._tid_next: Dict[int, int] = {}
        # request-scoped lanes: a bounded pool of rows under one
        # "requests" process, leased per live request id and RECYCLED
        # when the request reaches a terminal state — "millions of
        # users" must not mean millions of Chrome thread rows.  Beyond
        # the cap, request_lane() returns None and instrumentation
        # falls back to args-only attribution (the timeline is still
        # reconstructable by request id).
        self.request_lanes = int(request_lanes)
        self._req_lanes: Dict[Any, Lane] = {}
        self._req_free: List[Lane] = []
        self._req_created = 0

    # --- clock --------------------------------------------------------------
    def now(self) -> float:
        """Microseconds since tracer construction (monotonic)."""
        return (self._clock() - self._epoch) * 1e6

    # --- lanes --------------------------------------------------------------
    def lane(self, process: str, thread: str = "main") -> Lane:
        """The (pid, tid) pair for a named lane, registering on first use.

        Steady-state lookups are a lock-free dict hit; the lock is only
        taken to register a lane the first time it appears.
        """
        key = (process, thread)
        got = self._lanes.get(key)
        if got is not None:
            return got
        with self._lock:
            got = self._lanes.get(key)
            if got is None:
                pid = self._pids.get(process)
                if pid is None:
                    pid = len(self._pids) + 1
                    self._pids[process] = pid
                tid = self._tid_next.get(pid, 0) + 1
                self._tid_next[pid] = tid
                got = (pid, tid)
                self._lanes[key] = got
        return got

    def request_lane(self, request_id: Any,
                     lease: bool = True) -> Optional[Lane]:
        """The recycled per-request lane for a live request id, or
        ``None`` when the pool (``request_lanes``) is exhausted.

        The same id always maps to the same lane until
        :meth:`release_request_lane` returns it to the pool, so one
        request's whole waterfall — across engines, across a
        mid-stream migration — renders on one Perfetto row.

        ``lease=False`` only looks up an EXISTING lease.  Mid-request
        instrumentation (segment closes, terminal markers) must peek,
        never lease: under pool exhaustion a request that started
        without a lane would otherwise grab a lane freed by a later
        terminal request and emit retroactive spans overlapping the
        previous tenant's on the same row.
        """
        got = self._req_lanes.get(request_id)
        if got is not None or not lease:
            return got
        with self._lock:
            got = self._req_lanes.get(request_id)
            if got is not None:
                return got
            if self._req_free:
                lane = self._req_free.pop()
            elif self._req_created < self.request_lanes:
                self._req_created += 1
                lane = self.lane("requests", f"lane {self._req_created}")
            else:
                return None
            self._req_lanes[request_id] = lane
            return lane

    def release_request_lane(self, request_id: Any) -> None:
        """Return a terminal request's lane to the pool (no-op for ids
        that never leased one)."""
        with self._lock:
            lane = self._req_lanes.pop(request_id, None)
            if lane is not None:
                self._req_free.append(lane)

    # --- recording ----------------------------------------------------------
    def _append(self, ev: tuple) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def complete(self, name: str, lane: Lane, start_us: float,
                 args: Optional[Dict[str, Any]] = None,
                 dur_us: Optional[float] = None) -> None:
        """One complete ("X") event from ``start_us`` to now (or for an
        explicit ``dur_us``, when the caller measured the duration itself
        — e.g. ``host_dispatch``, whose duration the pipeline summed over
        its issue loops).  Duration clamps at zero: a fake or stepped
        clock must not emit negative spans."""
        if dur_us is None:
            dur_us = self.now() - start_us
        self._append(("X", name, start_us, max(dur_us, 0.0),
                      lane[0], lane[1], args, None))

    def span(self, name: str, lane: Lane,
             args: Optional[Dict[str, Any]] = None) -> _Span:
        """Context manager recording a complete event around its body."""
        return _Span(self, name, lane, args)

    def instant(self, name: str, lane: Lane,
                args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker ("i", thread-scoped)."""
        self._append(("i", name, self.now(), 0.0,
                      lane[0], lane[1], args, None))

    def counter(self, name: str, lane: Lane,
                values: Dict[str, float]) -> None:
        """A counter sample ("C"): Perfetto draws one track per key."""
        self._append(("C", name, self.now(), 0.0,
                      lane[0], lane[1], dict(values), None))

    def async_begin(self, name: str, lane: Lane, async_id: int,
                    args: Optional[Dict[str, Any]] = None) -> None:
        """Open an async arc ("b"): spans an operation whose begin and
        end happen in different call frames (the self-heal
        detect -> re-allocate -> rebuild sequence)."""
        self._append(("b", name, self.now(), 0.0,
                      lane[0], lane[1], args, int(async_id)))

    def async_end(self, name: str, lane: Lane, async_id: int,
                  args: Optional[Dict[str, Any]] = None) -> None:
        self._append(("e", name, self.now(), 0.0,
                      lane[0], lane[1], args, int(async_id)))

    # --- introspection ------------------------------------------------------
    @property
    def event_count(self) -> int:
        return len(self._events)

    def events(self) -> List[tuple]:
        """Snapshot of the raw event tuples (oldest first)."""
        return list(self._events)

    # --- export -------------------------------------------------------------
    def to_chrome(self, since_us: Optional[float] = None) -> Dict[str, Any]:
        """The trace as a Chrome Trace Event Format object.

        Every event (metadata included) carries the full required key
        set ``ph``/``ts``/``pid``/``tid``/``name`` so consumers can
        validate one uniform schema.  Lane metadata (process/thread
        names, sort order) is emitted first; viewers apply it to all
        subsequent events regardless of buffer eviction.

        ``since_us`` exports only events with ``ts >= since_us`` (lane
        metadata always included) — the autotuner analyzes one window
        at a time, and filtering raw tuples here beats materializing
        the full ring buffer just to discard most of it.  Async arcs
        ("b"/"e") that BEGAN before the window but end inside it (or
        are still open) get their begin re-synthesized at
        ``ts=since_us`` with ``args.clipped=True``: a window must never
        export a dangling ``e`` whose arc the viewer cannot open.
        """
        out: List[Dict[str, Any]] = []
        with self._lock:
            lanes = dict(self._lanes)
        seen_pids = set()
        for (process, thread), (pid, tid) in sorted(
            lanes.items(), key=lambda kv: kv[1]
        ):
            if pid not in seen_pids:
                seen_pids.add(pid)
                out.append({"ph": "M", "name": "process_name", "ts": 0.0,
                            "pid": pid, "tid": 0,
                            "args": {"name": process}})
                out.append({"ph": "M", "name": "process_sort_index",
                            "ts": 0.0, "pid": pid, "tid": 0,
                            "args": {"sort_index": pid}})
            out.append({"ph": "M", "name": "thread_name", "ts": 0.0,
                        "pid": pid, "tid": tid, "args": {"name": thread}})
        events = list(self._events)
        if since_us is not None:
            open_arcs: Dict[tuple, tuple] = {}
            for ph, name, ts, dur, pid, tid, args, aid in events:
                if ts >= since_us or ph not in ("b", "e"):
                    continue
                key = (name, pid, tid, aid)
                if ph == "b":
                    open_arcs[key] = (name, pid, tid, args, aid)
                else:
                    open_arcs.pop(key, None)
            for name, pid, tid, args, aid in open_arcs.values():
                out.append({
                    "ph": "b", "name": name, "ts": float(since_us),
                    "pid": pid, "tid": tid, "cat": "skytpu", "id": aid,
                    "args": dict(args or {}, clipped=True),
                })
        for ph, name, ts, dur, pid, tid, args, aid in events:
            if since_us is not None and ts < since_us:
                continue
            ev: Dict[str, Any] = {"ph": ph, "name": name, "ts": ts,
                                  "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = dur
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            elif ph in ("b", "e"):
                ev["cat"] = "skytpu"
                ev["id"] = aid
            if args:
                ev["args"] = args
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": "skycomputing_tpu_torch.telemetry",
                "dropped_events": self.dropped,
                "capacity": self.capacity,
            },
        }

    def write(self, path: str) -> str:
        """Serialize the trace to ``path`` (strict JSON) and return it."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return path


# --- process-global tracer state --------------------------------------------
# One active tracer per process, matching the engines it instruments
# (module-global like _TRANSFER_STATS in parallel/pipeline.py).  The
# boxed-list idiom keeps reads monomorphic and lets tests swap state.
_STATE: List[Optional[Tracer]] = [None]


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or ``None`` when tracing is disabled.

    This is THE hot-path accessor: instrumentation sites call it once
    per step/tick, test ``is None``, and skip all tracing work when
    disabled — the disabled cost is one function call and one compare.
    """
    return _STATE[0]


def enable_tracing(capacity: int = _DEFAULT_CAPACITY,
                   clock: Callable[[], float] = time.monotonic,
                   request_lanes: int = 32) -> Tracer:
    """Install (or return the already-active) process-global tracer.

    Idempotent by design: a ``TraceHook`` and a serving engine in one
    process share a single timeline instead of racing to own it —
    callers that need a private tracer construct :class:`Tracer`
    directly.
    """
    if _STATE[0] is None:
        _STATE[0] = Tracer(capacity=capacity, clock=clock,
                           request_lanes=request_lanes)
    return _STATE[0]


def disable_tracing() -> Optional[Tracer]:
    """Deactivate tracing; returns the tracer so the caller can still
    export what it recorded."""
    tracer = _STATE[0]
    _STATE[0] = None
    return tracer


def trace_span(name: str, process: str, thread: str = "main",
               args: Optional[Dict[str, Any]] = None):
    """Span-or-no-op for cool paths (allocator solves, checkpoint saves).

    When tracing is disabled this returns one shared singleton — zero
    allocation, zero clock reads — so library code can wrap phases
    unconditionally.  Hot loops should instead hoist ``get_tracer()``
    out of the loop and call :meth:`Tracer.complete` directly.
    """
    tracer = _STATE[0]
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(name, tracer.lane(process, thread), args)


__all__ = [
    "Tracer",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "trace_span",
]
