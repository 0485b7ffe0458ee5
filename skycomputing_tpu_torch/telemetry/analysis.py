"""Trace analysis (the port's own copy of the analysis core of
``skycomputing_tpu/telemetry/analysis.py``; pure stdlib).

Consumes Chrome-trace timelines produced by :mod:`.tracer` (``TraceHook``
for training, a traced ``ServingEngine`` for serving) and computes the schedule-shape numbers the paper's
headline claim is about:

- **per-stage utilization / busy time** — busy fraction and absolute
  busy milliseconds of each ``stage N`` lane over the analysis window
  (PipeDream's per-stage occupancy method);
- **bubble fraction** — ``1 - total_stage_busy / (num_stages x
  window)``: the share of stage-seconds spent idle;
- **critical path** — the union of stage-busy intervals vs pure-stall
  gaps where NO stage had work in flight;
- **step times** — distribution over ``iter`` spans (TraceHook rows);
- **host dispatch** — the ``host_dispatch`` spans' share of the window;
- **transfers** — ``transfer`` and ``transfer_elided`` instants;
- **serving breakdown** — prefill (the TTFT component) and decode (the
  TPOT component) span distributions, admissions, preemptions and
  stalls, and a per-bucket prefill histogram with padding waste, which
  ``tuning.TuningAdvisor`` reads;
- **request timelines** — one request's waterfall of ``queue_wait`` /
  ``prefill`` / ``decode`` segments and lifecycle instants across
  replicas (``trace_report --request``).

The port's spans time the host issuing work, as the reference's do: on
one card every stage shares the device, so the stages' spans follow one
another and the bubble fraction is at least ``1 - 1/S`` by
construction.  The reference's ``xla_compiles`` count has no
counterpart (nothing compiles).  The regression gate
(:func:`baseline_targets`, :func:`check_regression`) is the reference's,
read by ``python -m skycomputing_tpu_torch.tools.trace_report``.

Pure stdlib by contract (``pure_stdlib`` in ``analysis/audit.py``'s
manifest): ``tools/bench_autotune.py --smoke`` loads this module by file
path with no torch installed.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

STAGE_RE = re.compile(r"^stage\s+(\d+)")
# step-time keys a BENCH json may carry, and their scale to ms (None:
# recognized, never a step time)
_STEP_KEYS_MS = {"step_ms": 1.0, "dispatch_ms": None, "step_wall_s": 1e3,
                 "step_s": 1e3, "step_time_s": 1e3}


class TraceError(Exception):
    """Malformed or unanalyzable trace input."""


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def load_events(path: str) -> List[Dict[str, Any]]:
    """Events from a Chrome trace file (object form or bare array)."""
    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            raise TraceError(f"{path}: no traceEvents array")
        return events
    if isinstance(data, list):
        return data
    raise TraceError(f"{path}: expected trace object or event array")


def lane_processes(events: List[Dict[str, Any]]) -> Dict[int, str]:
    """pid -> process name, from "M" metadata events."""
    out: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            out[ev["pid"]] = ev.get("args", {}).get("name", str(ev["pid"]))
    return out


# --------------------------------------------------------------------------
# interval math
# --------------------------------------------------------------------------


def merge_intervals(
    intervals: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Union of possibly-overlapping [t0, t1) intervals."""
    merged: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    return sum(t1 - t0 for t0, t1 in merge_intervals(intervals))


def _pct(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile, stdlib-only (no numpy on CI runners)."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      round(q / 100.0 * (len(ordered) - 1))))
    return ordered[rank]


# --------------------------------------------------------------------------
# analysis
# --------------------------------------------------------------------------


def stage_spans(
    events: List[Dict[str, Any]]
) -> Dict[int, List[Tuple[float, float]]]:
    """stage index -> list of (t0, t1) busy intervals from "X" events on
    ``stage N`` lanes (fwd/bwd/update/prefill/decode alike — occupancy
    is occupancy)."""
    processes = lane_processes(events)
    stage_pids: Dict[int, int] = {}
    for pid, name in processes.items():
        m = STAGE_RE.match(name)
        if m:
            stage_pids[pid] = int(m.group(1))
    out: Dict[int, List[Tuple[float, float]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        stage = stage_pids.get(ev.get("pid"))
        if stage is None:
            continue
        t0 = float(ev["ts"])
        out.setdefault(stage, []).append((t0, t0 + float(ev.get("dur", 0))))
    return out


def named_durations(events: List[Dict[str, Any]], name: str) -> List[float]:
    """Durations (us) of every "X" event with the given name."""
    return [float(ev.get("dur", 0)) for ev in events
            if ev.get("ph") == "X" and ev.get("name") == name]


def count_instants(events: List[Dict[str, Any]], name: str) -> int:
    return sum(1 for ev in events
               if ev.get("ph") == "i" and ev.get("name") == name)


def _clip(
    intervals: List[Tuple[float, float]], lo: float, hi: float
) -> List[Tuple[float, float]]:
    return [(max(t0, lo), min(t1, hi))
            for t0, t1 in intervals if t1 > lo and t0 < hi]


def _bucket_histogram(
    events: List[Dict[str, Any]], serving_pids: set
) -> Dict[str, Dict[str, Any]]:
    """Per-bucket prefill accounting from engine-lane prefill spans.

    The engine's prefill span args carry the wave's bucket, request
    count, and true token count, so padding waste is computable per
    bucket: ``1 - tokens / (bucket * requests)`` is the share of
    prefill FLOPs spent on pad positions — the skewed-bucket signature
    the serving autotuner acts on.
    """
    hist: Dict[int, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != "prefill":
            continue
        if ev.get("pid") not in serving_pids:
            continue
        args = ev.get("args") or {}
        bucket = args.get("bucket")
        if bucket is None:
            continue
        row = hist.setdefault(
            int(bucket), {"waves": 0, "requests": 0, "tokens": 0}
        )
        row["waves"] += 1
        row["requests"] += int(args.get("wave", 0))
        row["tokens"] += int(args.get("tokens", 0))
    out: Dict[str, Dict[str, Any]] = {}
    for bucket in sorted(hist):
        row = hist[bucket]
        capacity = bucket * row["requests"]
        padded = (
            round(1.0 - row["tokens"] / capacity, 4)
            if capacity > 0 and row["tokens"] > 0 else None
        )
        out[str(bucket)] = {
            "waves": int(row["waves"]),
            "requests": int(row["requests"]),
            "tokens": int(row["tokens"]),
            "padded_fraction": padded,
        }
    return out


def analyze(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The full report dict over one trace's events."""
    spans = stage_spans(events)
    if not spans:
        raise TraceError(
            "no stage lanes found (expected process names like "
            "'stage 0 [device]' with X events)"
        )
    # the analysis window: iteration spans when the trace has them (they
    # bound exactly the steady-state region someone gated on — a mid-run
    # checkpoint or eval phase outside them must not count as bubble),
    # otherwise the extent of stage activity
    iter_spans = [
        (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
        for ev in events
        if ev.get("ph") == "X" and ev.get("name") == "iter"
    ]
    iter_durs = [t1 - t0 for t0, t1 in iter_spans]
    if iter_spans:
        window = (min(t0 for t0, _ in iter_spans),
                  max(t1 for _, t1 in iter_spans))
        spans = {k: _clip(iv, *window) for k, iv in spans.items()}
        spans = {k: iv for k, iv in spans.items() if iv}
        if not spans:
            raise TraceError("no stage activity inside the iter spans")
    else:
        all_points = [
            t for iv in spans.values() for t01 in iv for t in t01
        ]
        window = (min(all_points), max(all_points))
    window_us = window[1] - window[0]
    if window_us <= 0:
        raise TraceError("degenerate analysis window (no stage activity)")

    stages = sorted(spans)
    stage_busy = {k: busy_us(spans[k]) for k in stages}
    utilization = {k: stage_busy[k] / window_us for k in stages}
    total_busy = sum(stage_busy.values())
    bubble_fraction = 1.0 - total_busy / (len(stages) * window_us)
    # critical path: time when AT LEAST one stage is busy; the remainder
    # of the window is pure stall (host-only time — nothing in flight)
    union = busy_us([iv for k in stages for iv in spans[k]])
    report: Dict[str, Any] = {
        "window_ms": window_us / 1e3,
        "num_stages": len(stages),
        "stage_utilization": {str(k): round(v, 4)
                              for k, v in utilization.items()},
        "stage_busy_ms": {str(k): round(stage_busy[k] / 1e3, 3)
                          for k in stages},
        "bubble_fraction": round(bubble_fraction, 4),
        "critical_path_ms": round(union / 1e3, 3),
        "pure_stall_ms": round((window_us - union) / 1e3, 3),
        "events": len(events),
    }
    if iter_durs:
        report["steps"] = {
            "count": len(iter_durs),
            "mean_ms": round(sum(iter_durs) / len(iter_durs) / 1e3, 3),
            "p50_ms": round(_pct(iter_durs, 50) / 1e3, 3),
            "p95_ms": round(_pct(iter_durs, 95) / 1e3, 3),
        }
    # serving breakdown: prefill spans bound TTFT (admission -> first
    # token), decode spans bound TPOT (one tick = one token for every
    # active request)
    prefill = named_durations(events, "prefill")
    decode = named_durations(events, "decode")
    serving_lanes = {
        pid for pid, name in lane_processes(events).items()
        if name == "serving"
    }
    if prefill or decode:
        # engine-level spans only (per-stage prefill/decode spans share
        # names; the engine lane carries the end-to-end figure)
        eng_prefill = [float(ev["dur"]) for ev in events
                       if ev.get("ph") == "X" and ev["name"] == "prefill"
                       and ev.get("pid") in serving_lanes]
        eng_decode = [float(ev["dur"]) for ev in events
                      if ev.get("ph") == "X" and ev["name"] == "decode"
                      and ev.get("pid") in serving_lanes]
        prefill, decode = eng_prefill or prefill, eng_decode or decode
        report["serving"] = {
            "prefill_waves": len(prefill),
            "decode_ticks": len(decode),
            "ttft_component_p50_ms": round(
                (_pct(prefill, 50) or 0.0) / 1e3, 3),
            "ttft_component_p95_ms": round(
                (_pct(prefill, 95) or 0.0) / 1e3, 3),
            "tpot_component_p50_ms": round(
                (_pct(decode, 50) or 0.0) / 1e3, 3),
            "tpot_component_p95_ms": round(
                (_pct(decode, 95) or 0.0) / 1e3, 3),
            "admissions": count_instants(events, "admit"),
            "preemptions": count_instants(events, "preempt"),
            "queue_stalls": count_instants(events, "queue_stall"),
            "buckets": _bucket_histogram(events, serving_lanes),
        }
        # the aggregate padding waste is THE skewed-bucket signal, and
        # both its consumers (the advisor's decide step and the serving
        # tuner's commit/rollback judge) read this one field — a single
        # implementation, so they can never disagree
        padding = serving_padding_fraction(report["serving"])
        report["serving"]["padding_fraction"] = (
            round(padding, 4) if padding is not None else None
        )
    # host-dispatch share: one "host_dispatch" span per train step (its
    # duration IS the engine's PipelineStats.dispatch_s), so the trace
    # carries the same dispatch fraction the engine reports — the figure
    # the mesh-native drive collapses
    dispatch = _clip(
        [
            (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
            for ev in events
            if ev.get("ph") == "X" and ev.get("name") == "host_dispatch"
        ],
        *window,
    )
    if dispatch:
        dispatch_us = busy_us(dispatch)
        report["dispatch"] = {
            "total_ms": round(dispatch_us / 1e3, 3),
            "share": round(dispatch_us / window_us, 4),
            "steps": len(dispatch),
        }
    report["transfers"] = {
        "copies": count_instants(events, "transfer"),
        "elided": count_instants(events, "transfer_elided"),
    }
    return report


def measured_stage_seconds(report: Dict[str, Any],
                           steps: Optional[int] = None) -> List[float]:
    """Per-stage busy seconds *per step*, stage order — the measurement
    vector ``Allocator.refine_allocation`` / ``stage_divergence`` expect.

    ``steps`` overrides the step count when the trace has no ``iter``
    spans (an AutotuneHook window measured its own iteration count);
    with neither, the whole window counts as one step.
    """
    busy = report.get("stage_busy_ms") or {}
    if not busy:
        raise TraceError("report has no stage_busy_ms")
    n = steps or (report.get("steps") or {}).get("count") or 1
    if n < 1:
        raise TraceError(f"invalid step count {n}")
    return [busy[k] / 1e3 / n for k in sorted(busy, key=int)]


def serving_padding_fraction(
    serving: Optional[Dict[str, Any]]
) -> Optional[float]:
    """Token-weighted prefill padding waste over the bucket histogram:
    the fraction of prefill positions that were pad, across all waves.
    None when the trace carries no per-bucket token accounting."""
    if not serving:
        return None
    hist = serving.get("buckets") or {}
    capacity = tokens = 0
    for bucket, row in hist.items():
        if row.get("tokens") and row.get("requests"):
            capacity += int(bucket) * row["requests"]
            tokens += row["tokens"]
    if capacity <= 0:
        return None
    return 1.0 - tokens / capacity


# --------------------------------------------------------------------------
# request-scoped timeline reconstruction
# --------------------------------------------------------------------------

#: span names the request lanes emit, one per waterfall segment kind
REQUEST_SEGMENT_NAMES = ("queue_wait", "prefill", "decode")
#: instants that end a request's story (nothing more may follow)
REQUEST_TERMINAL_NAMES = ("finish", "failed", "rejected", "shed")


def request_timeline(events: List[Dict[str, Any]],
                     request_id: int) -> Dict[str, Any]:
    """One request's end-to-end waterfall from a Chrome trace.

    Selects every event whose args carry ``request == request_id`` —
    the request-lane ``queue_wait``/``prefill``/``decode`` spans plus
    lifecycle instants (``submitted``/``queued``/``dispatch``/
    ``admit``/``preempt``/``migrate``/``limbo``/``finish``/...) — and
    orders them into segments with per-segment replica attribution.
    A migrated request reads as: segments on replica A, a ``migrate``
    marker, segments on replica B — one id, one timeline.

    Returns ``segments`` (spans, time-ordered), ``markers``
    (instants), ``replicas`` (distinct attribution, first-seen order),
    ``migrations``, ``complete`` (reached a terminal marker),
    ``orphan_spans`` (spans that start after the terminal marker —
    zero in a well-formed trace), and ``max_gap_ms`` between adjacent
    segments.
    """
    rid = request_id
    spans: List[Dict[str, Any]] = []
    markers: List[Dict[str, Any]] = []
    for ev in events:
        args = ev.get("args") or {}
        if args.get("request") != rid:
            continue
        if (ev.get("ph") == "X"
                and ev.get("name") in REQUEST_SEGMENT_NAMES):
            t0 = float(ev["ts"])
            t1 = t0 + float(ev.get("dur", 0))
            spans.append({
                "name": ev["name"],
                "start_ms": t0 / 1e3,
                "end_ms": t1 / 1e3,
                "duration_ms": (t1 - t0) / 1e3,
                "replica": args.get("replica"),
                "args": {k: v for k, v in args.items()
                         if k != "request"},
            })
        elif ev.get("ph") == "i":
            markers.append({
                "name": ev["name"],
                "ts_ms": float(ev["ts"]) / 1e3,
                "replica": args.get("replica") or args.get("from"),
                "args": {k: v for k, v in args.items()
                         if k != "request"},
            })
    if not spans and not markers:
        raise TraceError(f"no events carry request id {rid}")
    spans.sort(key=lambda s: (s["start_ms"], s["end_ms"]))
    markers.sort(key=lambda m: m["ts_ms"])
    replicas: List[str] = []
    for item in sorted(spans + markers,
                       key=lambda x: x.get("start_ms", x.get("ts_ms"))):
        rep = item.get("replica")
        if rep and rep not in replicas:
            replicas.append(rep)
    terminal = [m for m in markers
                if m["name"] in REQUEST_TERMINAL_NAMES]
    end_of_story = terminal[-1]["ts_ms"] if terminal else None
    orphans = (
        [s for s in spans if s["start_ms"] > end_of_story + 1e-6]
        if end_of_story is not None else []
    )
    gaps = [
        max(0.0, b["start_ms"] - a["end_ms"])
        for a, b in zip(spans, spans[1:])
    ]
    points = ([s["start_ms"] for s in spans]
              + [s["end_ms"] for s in spans]
              + [m["ts_ms"] for m in markers])
    return {
        "request": rid,
        "segments": spans,
        "markers": markers,
        "replicas": replicas,
        "migrations": sum(1 for m in markers if m["name"] == "migrate"),
        "preemptions": sum(1 for m in markers
                           if m["name"] == "preempt"),
        "complete": bool(terminal),
        "terminal": terminal[-1]["name"] if terminal else None,
        "orphan_spans": len(orphans),
        "max_gap_ms": round(max(gaps), 3) if gaps else 0.0,
        "start_ms": min(points),
        "end_ms": max(points),
    }


def request_ids(events: List[Dict[str, Any]]) -> List[int]:
    """Every distinct request id appearing in the trace's args."""
    seen = set()
    for ev in events:
        rid = (ev.get("args") or {}).get("request")
        if isinstance(rid, int):
            seen.add(rid)
    return sorted(seen)


# --------------------------------------------------------------------------
# regression gate
# --------------------------------------------------------------------------


def _walk_numeric(obj: Any, key_names, found: List[float]) -> None:
    if isinstance(obj, dict):
        for key, value in obj.items():
            if key in key_names and isinstance(value, (int, float)):
                found.append(float(value))
            else:
                _walk_numeric(value, key_names, found)
    elif isinstance(obj, list):
        for item in obj:
            _walk_numeric(item, key_names, found)


def baseline_targets(path: str) -> Dict[str, float]:
    """Best step time (ms) and bubble fraction recorded in a BENCH json.

    Committed BENCH_*.json artifacts nest their figures differently per
    round, so extraction is by key name, recursively: the MINIMUM over
    all ``step_ms``/``step_wall_s``/``step_s`` occurrences is the
    trajectory's best step time — the gate's reference point.
    """
    with open(path) as fh:
        data = json.load(fh)
    out: Dict[str, float] = {}
    steps: List[float] = []
    for key, scale in _STEP_KEYS_MS.items():
        if scale is None:
            continue
        found: List[float] = []
        _walk_numeric(data, {key}, found)
        steps.extend(v * scale for v in found)
    positive = [v for v in steps if v > 0]
    if positive:  # all-zero placeholders -> "no recognized keys" path
        out["step_ms"] = min(positive)
    bubbles: List[float] = []
    _walk_numeric(data, {"bubble_fraction"}, bubbles)
    if bubbles:
        out["bubble_fraction"] = min(bubbles)
    return out


def check_regression(
    report: Dict[str, Any], targets: Dict[str, float], tolerance: float
) -> List[str]:
    """Human-readable failure list (empty = within tolerance)."""
    failures: List[str] = []
    base_step = targets.get("step_ms")
    if base_step is not None:
        steps = report.get("steps")
        if steps is None:
            failures.append(
                "baseline has a step time but the trace has no 'iter' "
                "spans to compare (record with TraceHook)"
            )
        elif steps["p50_ms"] > base_step * (1.0 + tolerance):
            failures.append(
                f"step time regressed: trace p50 {steps['p50_ms']:.2f} ms "
                f"> baseline {base_step:.2f} ms + {tolerance:.0%}"
            )
    base_bubble = targets.get("bubble_fraction")
    if base_bubble is not None:
        got = report["bubble_fraction"]
        # absolute slack floor: a 0.02 -> 0.04 bubble move is noise on
        # a near-perfect schedule, not a 2x regression
        limit = max(base_bubble * (1.0 + tolerance), base_bubble + 0.02)
        if got > limit:
            failures.append(
                f"bubble fraction regressed: trace {got:.4f} > baseline "
                f"{base_bubble:.4f} (+{tolerance:.0%}, floor +0.02)"
            )
    return failures


__all__ = [
    "REQUEST_SEGMENT_NAMES",
    "REQUEST_TERMINAL_NAMES",
    "TraceError",
    "analyze",
    "baseline_targets",
    "check_regression",
    "busy_us",
    "count_instants",
    "lane_processes",
    "load_events",
    "measured_stage_seconds",
    "merge_intervals",
    "named_durations",
    "request_ids",
    "request_timeline",
    "serving_padding_fraction",
    "stage_spans",
]
