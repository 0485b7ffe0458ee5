"""Whole-run invariant auditor: what a chaos campaign must NOT break
(the port of ``skycomputing_tpu/chaos/invariants.py``).

The injector (:mod:`.injector`) proves faults happened; this module
proves the fleet's promises survived them.  One call —
:func:`audit_run` — over a finished replay's artifacts (the fleet, the
:class:`~..workload.player.PlayerReport`, optionally the fault-free
reference replay and the injector) returns an :class:`AuditReport` of
named checks:

- **tokens_conserved** — every admitted-and-finished request produced
  EXACTLY its requested token count (zero lost, zero duplicated), and
  no admitted request is left non-terminal;
- **terminal_reasoned** — every arrival is terminal with a reason:
  finished, FAILED with ``fail_reason``, or rejected with an admission
  reason — nothing vanished silently;
- **token_identity** — on a digest-equal trace, every stream that
  finished in BOTH the faulted and fault-free runs is token-identical:
  faults may delay or fail work, never corrupt it;
- **page_consistency** — every live engine passes the page pool's
  refcount/free-list audit (``check_consistency``) and replica slot
  accounting;
- **counters_monotonic** — every counter in the probe timeline is
  non-decreasing, and per-reason rejection counts sum to the total;
- **recovery_within_budget** — the fleet returned to a settled state
  within ``recovery_budget_ticks`` of the last injected fault
  (time-to-healthy, gated);
- **ledger_conserved** — on a disaggregated fleet (duck-typed off
  ``fleet.ledger``), the KV-handoff ledger's conservation invariant
  holds (every enqueued record in exactly one of pending / delivered /
  failed-with-reason) and no handoff is left stranded PENDING after
  the run drained; a plain fleet passes trivially.

:func:`make_probe` builds the per-tick ``sample_fn`` the player feeds
the timeline with; :func:`fleet_settled` is the shared 'healthy again'
predicate.  The report's :meth:`~AuditReport.digest` excludes request
ids and wall times, so two same-seed replays in one process digest
identically — the double-run determinism gate.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..fleet.replica import HEALTHY, RETIRED
from ..serving.batcher import FAILED, FINISHED

#: FleetStats counters the probe samples every tick (scalars only;
#: rejected_by_reason rides alongside as its own dict)
_PROBE_COUNTERS = (
    "submitted", "admitted", "dispatched", "rejected", "migrations",
    "failed", "reforms", "reform_failures", "missed_beats", "ticks",
    "scale_ups", "scale_downs", "scale_rejected", "faults_injected",
    "recoveries_completed",
)


def fleet_settled(fleet) -> bool:
    """The recovery predicate: every replica serving or honestly
    retired, nothing crashed-but-undetected, no migration limbo, at
    least one healthy replica, no live admission blip."""
    states_ok = all(r.state in (HEALTHY, RETIRED)
                    for r in fleet.replicas)
    crashed = any(r.crashed and r.state != RETIRED
                  for r in fleet.replicas)
    return (states_ok and not crashed
            and len(fleet.healthy_replicas) >= 1
            and not fleet._limbo
            and not getattr(fleet.admission, "blip_active", False))


def make_probe(fleet) -> Callable[[], Dict[str, Any]]:
    """A ``sample_fn`` for :class:`~..workload.player.ScenarioPlayer`:
    one dict per tick with fleet shape, the settled predicate, and the
    scalar counters — everything the auditor's timeline checks read."""

    def probe() -> Dict[str, Any]:
        snap = fleet.stats.snapshot()
        return dict(
            tick=int(fleet.tick),
            healthy=len(fleet.healthy_replicas),
            live=sum(1 for r in fleet.replicas
                     if r.state != RETIRED),
            quarantined=sum(1 for r in fleet.replicas
                            if r.state == RETIRED),
            limbo=len(fleet._limbo),
            settled=fleet_settled(fleet),
            counters={k: snap[k] for k in _PROBE_COUNTERS},
            rejected_by_reason=dict(snap["rejected_by_reason"]),
        )

    return probe


@dataclass
class AuditCheck:
    """One named invariant's verdict."""

    name: str
    ok: bool
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dict(name=self.name, ok=self.ok, detail=self.detail)


@dataclass
class AuditReport:
    """Every check from one :func:`audit_run` (artifact-ready)."""

    plan: str
    scenario: str
    checks: List[AuditCheck] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def failures(self) -> List[AuditCheck]:
        return [c for c in self.checks if not c.ok]

    def to_dict(self) -> Dict[str, Any]:
        return dict(
            plan=self.plan, scenario=self.scenario, ok=self.ok,
            checks=[c.to_dict() for c in self.checks],
        )

    def digest(self) -> str:
        """sha256 over the report content — request-id- and wall-time-
        free by construction, so same-seed replays digest equal."""
        return hashlib.sha256(
            repr(self.to_dict()).encode()
        ).hexdigest()


def _check_tokens_conserved(report) -> AuditCheck:
    lost: List[str] = []
    for v in report.admitted:
        r = v.request
        if r.status == FINISHED:
            if len(r.tokens) != v.arrival.new_tokens:
                lost.append(
                    f"arrival@{v.arrival.tick} generated "
                    f"{len(r.tokens)}/{v.arrival.new_tokens}"
                )
        elif r.status != FAILED:
            lost.append(
                f"arrival@{v.arrival.tick} left non-terminal "
                f"({r.status})"
            )
    return AuditCheck(
        "tokens_conserved", not lost,
        "; ".join(lost[:5]) if lost
        else f"{len(report.finished)} finished streams exact",
    )


def _check_terminal_reasoned(report) -> AuditCheck:
    bad: List[str] = []
    for v in report.verdicts:
        r = v.request
        if v.admitted:
            if r.status == FAILED and not r.fail_reason:
                bad.append(
                    f"arrival@{v.arrival.tick} FAILED without a reason"
                )
        elif not v.reason:
            bad.append(
                f"arrival@{v.arrival.tick} rejected without a reason"
            )
    return AuditCheck(
        "terminal_reasoned", not bad,
        "; ".join(bad[:5]) if bad
        else "every terminal state carries its reason",
    )


def _check_token_identity(report, reference) -> AuditCheck:
    if report.digest != reference.digest:
        return AuditCheck(
            "token_identity", False,
            "trace digests differ: the runs replayed different "
            "arrivals and cannot be compared",
        )
    if len(report.verdicts) != len(reference.verdicts):
        return AuditCheck(
            "token_identity", False,
            f"verdict counts differ ({len(report.verdicts)} vs "
            f"{len(reference.verdicts)})",
        )
    compared, divergent = 0, []
    for v, ref in zip(report.verdicts, reference.verdicts):
        if v.request.status == FINISHED \
                and ref.request.status == FINISHED:
            compared += 1
            if list(v.request.tokens) != list(ref.request.tokens):
                divergent.append(f"arrival@{v.arrival.tick}")
    return AuditCheck(
        "token_identity", not divergent,
        "; ".join(divergent[:5]) if divergent
        else f"{compared} streams token-identical to the fault-free "
             f"reference",
    )


def _check_page_consistency(fleet) -> AuditCheck:
    bad: List[str] = []
    for r in fleet.replicas:
        if r.state == RETIRED or r.engine is None:
            continue
        pool = getattr(r.engine, "_pool", None)
        if pool is not None:
            try:
                pool.check_consistency()
            except Exception as exc:
                bad.append(f"{r.name}: {exc}")
        if not r.slot_accounting_ok:
            bad.append(f"{r.name}: leaked slots")
    return AuditCheck(
        "page_consistency", not bad,
        "; ".join(bad[:5]) if bad
        else "every live pool and slot ledger consistent",
    )


def _check_counters_monotonic(fleet, report) -> AuditCheck:
    bad: List[str] = []
    prev: Dict[str, Any] = {}
    for sample in report.timeline:
        counters = sample.get("counters", {})
        for key, value in counters.items():
            before = prev.get(key)
            if before is not None and value < before:
                bad.append(
                    f"{key} regressed {before} -> {value} at tick "
                    f"{sample.get('tick')}"
                )
        prev.update(counters)
    by_reason = fleet.stats.rejected_by_reason
    if fleet.stats.rejected != sum(by_reason.values()):
        bad.append(
            f"rejected={fleet.stats.rejected} != "
            f"sum(by_reason)={sum(by_reason.values())}"
        )
    return AuditCheck(
        "counters_monotonic", not bad,
        "; ".join(bad[:5]) if bad
        else f"{len(_PROBE_COUNTERS)} counters monotonic across "
             f"{len(report.timeline)} samples",
    )


def _check_ledger_conserved(fleet) -> AuditCheck:
    ledger = getattr(fleet, "ledger", None)
    if ledger is None:
        return AuditCheck(
            "ledger_conserved", True, "fleet has no handoff ledger"
        )
    bad: List[str] = []
    summary = ledger.audit()
    if not summary["conservation_ok"]:
        bad.append(
            f"conservation broken: enqueued={summary['enqueued_total']}"
            f" pending={summary['pending']}"
            f" delivered={summary['delivered']}"
            f" failed={summary['failed']}"
        )
    if summary["pending"]:
        # the replay ran its idle epilogue: anything still PENDING was
        # stranded in flight, exactly what the ledger exists to forbid
        bad.append(
            f"{summary['pending']} handoff(s) stranded PENDING after "
            f"the run drained"
        )
    reasons = ", ".join(
        f"{r} x{n}"
        for r, n in sorted(summary["failed_reasons"].items())
    )
    return AuditCheck(
        "ledger_conserved", not bad,
        "; ".join(bad) if bad
        else (f"{summary['total']} handoffs conserved "
              f"({summary['delivered']} delivered, "
              f"{summary['failed']} failed"
              + (f": {reasons}" if reasons else "") + ")"),
    )


def _check_recovery(fleet, report, injector,
                    budget: Optional[int]) -> AuditCheck:
    if injector is None or injector.last_fault_tick is None:
        return AuditCheck(
            "recovery_within_budget", True, "no faults applied"
        )
    if budget is None:
        budget = injector.plan.recovery_budget_ticks
    worst, detail = 0, []
    for rec in injector.recoveries:
        took = rec["settled_tick"] - rec["fault_tick"]
        worst = max(worst, took)
        detail.append(f"{took}t")
    if injector._recovery_open:
        # the run drained before the injector's NEXT on_tick could
        # close the arc: find the first settled probe sample after the
        # last fault (or judge the fleet's final state directly)
        settled_at = next(
            (s["tick"] for s in report.timeline
             if s.get("settled") and s["tick"] > injector.last_fault_tick),
            None,
        )
        if settled_at is None and fleet_settled(fleet):
            settled_at = int(fleet.tick)
        if settled_at is None:
            return AuditCheck(
                "recovery_within_budget", False,
                f"fleet never settled after the fault at tick "
                f"{injector.last_fault_tick}",
            )
        took = settled_at - injector.last_fault_tick
        worst = max(worst, took)
        detail.append(f"{took}t")
    ok = worst <= budget
    return AuditCheck(
        "recovery_within_budget", ok,
        f"time-to-healthy {', '.join(detail)} (budget {budget}t)",
    )


def audit_run(
    fleet,
    report,
    *,
    reference=None,
    injector=None,
    recovery_budget_ticks: Optional[int] = None,
) -> AuditReport:
    """Audit one finished replay.  ``reference`` (the fault-free
    replay of the same digest-equal trace) enables the token-identity
    check; ``injector`` enables the recovery-budget check (budget
    defaults to the plan's own ``recovery_budget_ticks``)."""
    audit = AuditReport(
        plan=injector.plan.name if injector is not None else "",
        scenario=report.scenario,
    )
    audit.checks.append(_check_tokens_conserved(report))
    audit.checks.append(_check_terminal_reasoned(report))
    if reference is not None:
        audit.checks.append(_check_token_identity(report, reference))
    audit.checks.append(_check_page_consistency(fleet))
    audit.checks.append(_check_counters_monotonic(fleet, report))
    audit.checks.append(_check_ledger_conserved(fleet))
    audit.checks.append(
        _check_recovery(fleet, report, injector,
                        recovery_budget_ticks)
    )
    return audit


__all__ = [
    "AuditCheck",
    "AuditReport",
    "audit_run",
    "fleet_settled",
    "make_probe",
]
