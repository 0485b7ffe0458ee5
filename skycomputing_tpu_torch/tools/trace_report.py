"""Trace-driven bubble, dispatch and regression analysis of a Chrome
trace (the port of ``tools/trace_report.py``).

A thin command over :mod:`skycomputing_tpu_torch.telemetry.analysis`:
per-stage utilization, bubble fraction, critical path, the step-time
distribution and the host-dispatch share of a trace that ``TraceHook``
(or ``bench_step_overhead --trace-out``) wrote.

Regression gate::

    python -m skycomputing_tpu_torch.tools.trace_report trace.json \\
        --baseline BENCH.json [--tolerance 0.10]

takes the baseline's best step time (any nested ``step_ms`` /
``step_wall_s`` / ``step_s`` / ``step_time_s``) and its
``bubble_fraction``, and exits 2 when the trace regresses beyond the
tolerance.  ``--json`` prints the whole analysis as one JSON line (with
``--baseline``, the verdict under ``baseline_gate``).  ``--smoke``
analyzes the repository's fixture ``tools/fixtures/trace_smoke.json``
(read as data) and fails on structural drift.

``--incidents BUNDLE`` overlays a postmortem bundle (the incident
plane's artifact, ``python -m skycomputing_tpu_torch.tools.skyreport``
renders it): the incident's identity plus every ``incident_opened`` /
``incident_closed`` instant of the analyzed trace, printed after the
report (with ``--json``: under an ``incidents`` key).

The reference tool's request waterfall (``--request``) and serving
breakdown are not ported yet.  The tool reads and writes no device, so
it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..telemetry.analysis import (
    TraceError,
    analyze,
    baseline_targets,
    check_regression,
    load_events,
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def smoke_fixture() -> str:
    return os.path.join(_REPO, "tools", "fixtures", "trace_smoke.json")


def _print_human(report: Dict[str, Any]) -> None:
    print(f"# window {report['window_ms']:.2f} ms over "
          f"{report['num_stages']} stages, {report['events']} events")
    for stage, util in sorted(report["stage_utilization"].items(),
                              key=lambda kv: int(kv[0])):
        busy = report["stage_busy_ms"].get(stage, 0.0)
        print(f"#   stage {stage}: utilization {float(util) * 100:5.1f}% "
              f"({busy:.2f} ms busy)")
    print(f"# bubble fraction {report['bubble_fraction'] * 100:.1f}% | "
          f"critical path {report['critical_path_ms']:.2f} ms | "
          f"pure stall {report['pure_stall_ms']:.2f} ms")
    if "dispatch" in report:
        d = report["dispatch"]
        print(f"# host dispatch share {d['share'] * 100:.1f}% "
              f"({d['total_ms']:.2f} ms over {d['steps']} steps)")
    if "steps" in report:
        s = report["steps"]
        print(f"# steps: n={s['count']} mean {s['mean_ms']:.2f} ms "
              f"p50 {s['p50_ms']:.2f} p95 {s['p95_ms']:.2f}")
    print(f"# transfers {report['transfers']['copies']} copied, "
          f"{report['transfers']['elided']} elided")


def _smoke_problems(report: Dict[str, Any]) -> List[str]:
    """The fixture encodes a 2-stage pipeline with known idle time."""
    problems = []
    if report["num_stages"] < 2:
        problems.append("fixture lost its stage lanes")
    if not 0.0 < report["bubble_fraction"] < 1.0:
        problems.append(f"fixture bubble fraction "
                        f"{report['bubble_fraction']} not in (0, 1)")
    if "steps" not in report or report["steps"]["count"] < 1:
        problems.append("fixture lost its iter spans")
    return problems


def _incident_overlay(events: List[Dict[str, Any]],
                      bundle_path: str) -> Dict[str, Any]:
    """The ``--incidents`` overlay: the bundle's incident identity plus
    every incident-lifecycle instant present in the analyzed trace."""
    with open(bundle_path) as fh:
        bundle = json.load(fh)
    if not isinstance(bundle, dict):
        raise json.JSONDecodeError("bundle is not an object",
                                   bundle_path, 0)
    marks = [
        {"name": ev.get("name"),
         "ts_ms": float(ev.get("ts", 0.0)) / 1000.0,
         "args": ev.get("args") or {}}
        for ev in events
        if ev.get("ph") == "i"
        and ev.get("name") in ("incident_opened", "incident_closed")
    ]
    marks.sort(key=lambda m: m["ts_ms"])
    return {
        "bundle": bundle_path,
        "schema": bundle.get("schema"),
        "incident": bundle.get("incident") or {},
        "digest": bundle.get("digest"),
        "marks": marks,
    }


def _print_incidents(overlay: Dict[str, Any]) -> None:
    inc = overlay["incident"]
    closed = inc.get("closed_tick")
    print(f"# incident {inc.get('incident_id', '?')} "
          f"[{inc.get('severity', '?')}] rule={inc.get('rule', '?')} "
          f"opened@tick {inc.get('opened_tick', '?')}"
          + (f" closed@tick {closed}" if closed is not None
             else " (still open)"))
    if inc.get("reason"):
        print(f"#   reason: {inc['reason']}")
    if overlay.get("digest"):
        print(f"#   bundle digest: {overlay['digest']}")
    if not overlay["marks"]:
        print("#   (no incident instants in this trace window)")
    for m in overlay["marks"]:
        print(f"#   {m['ts_ms']:10.3f} ms {m['name']:<16} {m['args']}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trace", nargs="?",
                        help="Chrome-trace JSON file to analyze")
    parser.add_argument("--baseline", help="BENCH json to gate against")
    parser.add_argument("--tolerance", type=float, default=0.10,
                        help="allowed relative regression (default 0.10)")
    parser.add_argument("--json", action="store_true",
                        help="print the full analysis as one JSON line")
    parser.add_argument("--smoke", action="store_true",
                        help="analyze the repository's fixture trace and "
                             "check the report's structure")
    parser.add_argument("--incidents", metavar="BUNDLE",
                        help="postmortem bundle JSON (skyreport artifact) "
                             "to overlay: incident identity + open/close "
                             "instants on the timeline")
    args = parser.parse_args(argv)

    path = args.trace or (smoke_fixture() if args.smoke else None)
    if not path:
        parser.error("a trace file (or --smoke) is required")
    try:
        events = load_events(path)
        report = analyze(events)
    except (OSError, json.JSONDecodeError, TraceError, KeyError) as exc:
        print(f"trace_report: cannot analyze {path}: {exc}",
              file=sys.stderr)
        return 1

    overlay: Optional[Dict[str, Any]] = None
    if args.incidents:
        try:
            overlay = _incident_overlay(events, args.incidents)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"trace_report: cannot read incident bundle "
                  f"{args.incidents}: {exc}", file=sys.stderr)
            return 1

    failures: Optional[List[str]] = None
    if args.baseline:
        try:
            targets = baseline_targets(args.baseline)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"trace_report: cannot read baseline {args.baseline}: "
                  f"{exc}", file=sys.stderr)
            return 1
        if not targets:
            print(f"trace_report: baseline {args.baseline} has no "
                  f"recognized step/bubble keys", file=sys.stderr)
            return 1
        failures = check_regression(report, targets, args.tolerance)

    if args.json:
        if failures is not None:
            report = dict(report, baseline_gate={
                "baseline": args.baseline, "targets": targets,
                "tolerance": args.tolerance, "failures": failures,
                "ok": not failures})
        if overlay is not None:
            report = dict(report, incidents=overlay)
        print(json.dumps(report), flush=True)
    else:
        _print_human(report)
        if overlay is not None:
            _print_incidents(overlay)

    if args.smoke:
        problems = _smoke_problems(report)
        for p in problems:
            print(f"trace_report --smoke: {p}", file=sys.stderr)
        if problems:
            return 1
        print("# smoke: ok")

    if failures is not None:
        for failure in failures:
            print(f"REGRESSION: {failure}", file=sys.stderr)
        if failures:
            return 2
        if not args.json:
            print(f"# baseline gate: ok (vs {args.baseline}, tolerance "
                  f"{args.tolerance:.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
