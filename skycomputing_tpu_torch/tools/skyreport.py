"""skyreport: render an incident postmortem bundle as markdown (the port
of ``tools/skyreport.py``).

The incident plane (:mod:`skycomputing_tpu_torch.telemetry.incidents`)
snapshots one JSON bundle per opened incident — last-N flight events,
metrics summary, trace slice, health verdict, fleet topology — stamped
with a digest over its replay-deterministic subset
(``ServingFleet.bundles``).  This command renders one:

- the incident header (rule, severity, reason, open/close ticks),
- digest verification (recomputed against the stamped value),
- the cause chain (fault -> impact -> remediation -> settled),
  reconstructed from the bundle's flight log,
- a per-lane timeline of the flight events,
- topology / health / ledger-audit appendices.

``--format=json`` emits the same analysis as one JSON object instead.

Exit codes: 0 = rendered, digest verified; 1 = unreadable or malformed
bundle, or digest mismatch (the report still renders, so the reader
sees what mismatched).  Pure stdlib: it reads and writes no device.

Usage::

    python -m skycomputing_tpu_torch.tools.skyreport bundle.json \\
        [--format=json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from ..telemetry import incidents


def load_bundle(path: str) -> Dict[str, Any]:
    """Read and structurally validate one bundle file; raises
    ``ValueError`` on anything that is not a bundle."""
    with open(path, "r", encoding="utf-8") as fh:
        bundle = json.load(fh)
    if not isinstance(bundle, dict):
        raise ValueError(f"bundle root must be an object, "
                         f"got {type(bundle).__name__}")
    for key in ("schema", "incident", "flight_log", "digest"):
        if key not in bundle:
            raise ValueError(f"bundle missing required key {key!r}")
    if bundle["schema"] != incidents.BUNDLE_SCHEMA:
        raise ValueError(
            f"unknown bundle schema {bundle['schema']!r} "
            f"(expected {incidents.BUNDLE_SCHEMA!r})")
    if not isinstance(bundle["flight_log"], list):
        raise ValueError("bundle flight_log must be a list")
    return bundle


def analyze(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """The report skeleton both output formats share."""
    recomputed = incidents.bundle_digest(bundle)
    chain = incidents.cause_chain(bundle["flight_log"])
    lanes: Dict[str, List[Dict[str, Any]]] = {}
    for event in bundle["flight_log"]:
        if isinstance(event, dict):
            lanes.setdefault(str(event.get("lane", "?")), []).append(event)
    return {
        "incident": bundle["incident"],
        "digest": bundle["digest"],
        "digest_recomputed": recomputed,
        "digest_verified": recomputed == bundle["digest"],
        "cause_chain": chain,
        "stages": incidents.chain_stages(chain),
        "lanes": {lane: lanes[lane] for lane in sorted(lanes)},
        "event_count": len(bundle["flight_log"]),
        "topology": bundle.get("topology", {}),
        "healthz": bundle.get("healthz", {}),
        "ledger_audit": bundle.get("ledger_audit", {}),
        "metrics_keys": sorted((bundle.get("metrics") or {}).keys()),
    }


def _md_escape(text: Any) -> str:
    return str(text).replace("|", "\\|")


def render_markdown(report: Dict[str, Any]) -> str:
    inc = report["incident"]
    lines = [
        f"# Postmortem: {inc.get('incident_id', '?')}",
        "",
        f"- **rule**: `{inc.get('rule')}`",
        f"- **severity**: {inc.get('severity')}",
        f"- **opened tick**: {inc.get('opened_tick')}",
        f"- **closed tick**: "
        f"{inc.get('closed_tick') if inc.get('closed_tick') is not None else 'still open at snapshot'}",
        f"- **reason**: {inc.get('reason')}",
        f"- **bundle digest**: `{report['digest']}`"
        + (" (verified)" if report["digest_verified"]
           else f" **DIGEST MISMATCH** (recomputed "
                f"`{report['digest_recomputed']}`)"),
        "",
        "## Cause chain",
        "",
    ]
    if report["cause_chain"]:
        lines.append(" -> ".join(report["stages"]))
        lines.append("")
        lines.append("| tick | stage | lane | kind | subject |")
        lines.append("|---:|---|---|---|---|")
        for link in report["cause_chain"]:
            lines.append(
                f"| {link['tick']} | {link['stage']} | {link['lane']} "
                f"| `{link['kind']}` | {_md_escape(link['subject'])} |")
    else:
        lines.append("_No causally-staged events in the flight window._")
    lines += ["", "## Per-lane timeline", ""]
    for lane, events in report["lanes"].items():
        lines.append(f"### lane `{lane}` ({len(events)} events)")
        lines.append("")
        lines.append("| tick | kind | subject | detail |")
        lines.append("|---:|---|---|---|")
        for event in events:
            detail = json.dumps(event.get("detail", {}), sort_keys=True)
            lines.append(
                f"| {event.get('tick')} | `{event.get('kind')}` "
                f"| {_md_escape(event.get('subject', ''))} "
                f"| `{_md_escape(detail)}` |")
        lines.append("")
    lines += ["## Health verdict", "",
              "```json",
              json.dumps(report["healthz"], sort_keys=True, indent=2),
              "```", "",
              "## Topology", "",
              "```json",
              json.dumps(report["topology"], sort_keys=True, indent=2),
              "```", ""]
    if report["ledger_audit"]:
        lines += ["## Disagg ledger audit", "",
                  "```json",
                  json.dumps(report["ledger_audit"], sort_keys=True,
                             indent=2),
                  "```", ""]
    if report["metrics_keys"]:
        lines += ["## Metrics in window", "",
                  ", ".join(f"`{k}`" for k in report["metrics_keys"]), ""]
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Render an incident postmortem bundle")
    parser.add_argument("bundle", help="path to a bundle .json")
    parser.add_argument("--format", choices=("md", "json"), default="md",
                        help="output format (default: markdown)")
    args = parser.parse_args(argv)

    try:
        bundle = load_bundle(args.bundle)
    except (OSError, json.JSONDecodeError, ValueError) as exc:
        print(f"skyreport: cannot load bundle {args.bundle}: {exc}",
              file=sys.stderr)
        return 1

    report = analyze(bundle)
    if args.format == "json":
        print(json.dumps(report, sort_keys=True), flush=True)
    else:
        print(render_markdown(report), flush=True)
    if not report["digest_verified"]:
        print("skyreport: bundle digest mismatch — artifact was edited "
              "after it was stamped", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
