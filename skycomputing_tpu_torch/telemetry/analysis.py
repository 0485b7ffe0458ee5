"""Trace analysis (the port's own copy of the analysis core of
``skycomputing_tpu/telemetry/analysis.py``; pure stdlib).

Consumes Chrome-trace timelines produced by :mod:`.tracer` (``TraceHook``
for training) and computes the schedule-shape numbers the paper's
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
- **transfers** — ``transfer`` and ``transfer_elided`` instants.

The port's spans time the host issuing work, as the reference's do: on
one card every stage shares the device, so the stages' spans follow one
another and the bubble fraction is at least ``1 - 1/S`` by
construction.  The reference's ``xla_compiles`` count has no
counterpart (nothing compiles); its serving breakdown, request-timeline
reconstruction and regression gate serve the serving planes and the CI
tools, which are not ported (queue A item 4).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

STAGE_RE = re.compile(r"^stage\s+(\d+)")


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


__all__ = [
    "TraceError",
    "analyze",
    "busy_us",
    "count_instants",
    "lane_processes",
    "load_events",
    "measured_stage_seconds",
    "merge_intervals",
    "named_durations",
    "stage_spans",
]
