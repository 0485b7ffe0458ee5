"""Incident plane: pure rule engine over the flight recorder (the port's own
copy of ``skycomputing_tpu/telemetry/incidents.py``).

The fleet has metrics, traces and SLO burn alerts, and the chaos plane
replayable fault campaigns.  Nothing *consumed* those signals when the
fleet degraded — a chaos run ended in pass/fail gates and a pile of
counters.  This module closes the loop: a small catalog of detector
rules runs once per tick over the newly-recorded flight events plus the
``MetricsTimeseries``, and a triggered rule opens an :class:`Incident`
whose postmortem bundle (:func:`build_bundle`) is a self-contained,
replay-deterministic JSON artifact stamped with its own digest.

Everything here is duck-typed against the recorder (``events_since``,
``deterministic_log``, ``seq``) and the timeseries (``latest``,
``values``, ``keys``, ``type_of``) — no package imports, pure stdlib
by contract, loadable by file path on a bare CI runner.

Rule catalog:

========================  ========  =============================================
rule                      severity  fires when
========================  ========  =============================================
steady_state_recompile    warning   a ``recompile`` event lands past warmup
counter_regression        critical  a fleet-level counter moves backwards
queue_depth_spike         warning   queue depth >= factor x its own baseline
quarantine                critical  a replica is retired (supervisor gave up)
handoff_failure_streak    warning   >= threshold ledger failures in a window
slo_burn                  warning   sustained SLO ``firing_streak``
reform_backoff            warning   repeated re-form failures, backoff rising
replica_outage            critical  replica detected dead / slot-leaked
========================  ========  =============================================

``replica_outage`` deliberately ignores the supervisor's ``latency``
detect reason: that detector is EWMA-of-wall-time driven and would make
incident streams (and therefore bundle digests) wall-clock dependent.
"""

from __future__ import annotations

import hashlib
import json
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

SEV_INFO = "info"
SEV_WARNING = "warning"
SEV_CRITICAL = "critical"

#: severity ordering for healthz folding (higher = worse)
SEVERITY_RANK = {SEV_INFO: 0, SEV_WARNING: 1, SEV_CRITICAL: 2}

BUNDLE_SCHEMA = "skycomputing-incident-bundle-v1"

#: bundle keys folded into the bundle digest.  Metrics summaries and
#: chrome-trace slices carry wall-clock timestamps by construction, so
#: they ship in the bundle but stay OUT of its identity.
_BUNDLE_DIGEST_KEYS = ("schema", "incident", "flight_log", "topology")


class RuleContext:
    """What one evaluation tick sees: the tick, the flight events
    recorded since the previous evaluation, and the timeseries."""

    def __init__(self, tick: int, events: List[Any],
                 timeseries: Any = None):
        self.tick = tick
        self.events = events
        self.ts = timeseries

    def by_kind(self, kind: str) -> List[Any]:
        return [e for e in self.events if e.kind == kind]


class Rule:
    """One stateful detector.  ``update(ctx)`` runs each evaluated tick
    and returns a human-readable reason string when the rule is firing,
    else ``None``.  Rules may keep state across ticks (streak counters,
    baselines).

    ``every`` is the evaluation cadence: the engine calls the rule only
    on ticks divisible by it.  Cadence > 1 is ONLY sound for rules that
    read the timeseries — event-driven rules see just the events drained
    since the previous evaluation, so skipping a tick would drop events
    on the floor.  The recorder rides in the serving tick loop; a level
    check a few hundred microseconds cheaper every tick is the
    difference between "always on" and "on until someone profiles"."""

    name = "rule"
    severity = SEV_WARNING
    #: evaluation cadence in ticks (1 = every tick)
    every = 1

    def update(self, ctx: RuleContext) -> Optional[str]:
        raise NotImplementedError


class SteadyStateRecompileRule(Rule):
    """A compile past the warmup window means the bucket cover leaks —
    the zero-steady-state-recompile contract (serving plane) broke."""

    name = "steady_state_recompile"
    severity = SEV_WARNING

    def __init__(self, warmup_ticks: int = 10):
        self.warmup_ticks = int(warmup_ticks)

    def update(self, ctx: RuleContext) -> Optional[str]:
        if ctx.tick < self.warmup_ticks:
            return None
        hits = ctx.by_kind("recompile")
        if not hits:
            return None
        subjects = sorted({e.subject for e in hits})
        return (f"recompile past warmup (tick {ctx.tick} >= "
                f"{self.warmup_ticks}) on {', '.join(subjects)}")


class CounterRegressionRule(Rule):
    """Fleet-level counters are cumulative for the life of the fleet —
    a backwards step is data corruption, not a reset (per-replica
    counters DO reset on re-form, so only ``fleet.*`` keys are held to
    monotonicity)."""

    name = "counter_regression"
    severity = SEV_CRITICAL
    every = 4  # timeseries level check; a regression is permanent

    def __init__(self, prefix: str = "fleet."):
        self.prefix = prefix
        # this rule runs every tick over every fleet counter, so it is
        # the engine's hot path: remember each counter's last value and
        # read only ``latest()`` (O(1)) instead of re-slicing series
        self._last: Dict[str, float] = {}
        self._counters: Tuple[str, ...] = ()
        self._known_keys = -1

    def update(self, ctx: RuleContext) -> Optional[str]:
        if ctx.ts is None:
            return None
        count = getattr(ctx.ts, "key_count", ctx.ts.keys)()
        count = count if isinstance(count, int) else len(count)
        if count != self._known_keys:
            # key set grew (new replica/source registered): re-derive
            # the counter list once, not per tick
            self._known_keys = count
            self._counters = tuple(
                key for key in ctx.ts.keys()
                if key.startswith(self.prefix)
                and ctx.ts.type_of(key) == "counter")
        fired = None
        for key in self._counters:
            latest = ctx.ts.latest(key)
            if latest is None:
                continue
            prev = self._last.get(key)
            if prev is not None and latest < prev and fired is None:
                fired = (f"counter {key} moved backwards "
                         f"({prev} -> {latest})")
            self._last[key] = latest
        return fired


class QueueDepthSpikeRule(Rule):
    """Queue depth far above its own recent baseline: admission is
    outpacing service.  ``min_depth`` keeps bursty-but-healthy
    scenarios (flash crowds) below the bar."""

    name = "queue_depth_spike"
    severity = SEV_WARNING
    every = 2  # timeseries level check against a 32-tick baseline

    def __init__(self, metric: str = "fleet.queue_depth",
                 factor: float = 4.0, min_depth: float = 24.0,
                 baseline_window: int = 32):
        self.metric = metric
        self.factor = float(factor)
        self.min_depth = float(min_depth)
        self.baseline_window = int(baseline_window)

    def update(self, ctx: RuleContext) -> Optional[str]:
        if ctx.ts is None:
            return None
        values = ctx.ts.values(self.metric, self.baseline_window)
        if len(values) < 4:
            return None
        latest = values[-1]
        history = sorted(values[:-1])
        baseline = history[len(history) // 2]  # median
        bar = max(self.min_depth, self.factor * max(baseline, 1.0))
        if latest >= bar:
            return (f"queue depth {latest:g} >= {bar:g} "
                    f"(baseline {baseline:g} x{self.factor:g}, "
                    f"floor {self.min_depth:g})")
        return None


class QuarantineRule(Rule):
    """The supervisor retiring a replica means heal-with-backoff gave
    up — capacity is permanently down until a scale-up replaces it."""

    name = "quarantine"
    severity = SEV_CRITICAL

    def update(self, ctx: RuleContext) -> Optional[str]:
        hits = ctx.by_kind("replica_retired")
        hits += [e for e in ctx.by_kind("reform_failed")
                 if e.detail.get("retired")]
        if not hits:
            return None
        subjects = sorted({e.subject for e in hits})
        return f"replica quarantined: {', '.join(subjects)}"


class HandoffFailureStreakRule(Rule):
    """Repeated KV-handoff failures inside a window: the prefill ->
    decode plane is dropping or corrupting payloads faster than a
    one-off recompute fallback explains."""

    name = "handoff_failure_streak"
    severity = SEV_WARNING

    def __init__(self, threshold: int = 2, window_ticks: int = 40):
        self.threshold = int(threshold)
        self.window_ticks = int(window_ticks)
        self._fail_ticks: List[int] = []

    def update(self, ctx: RuleContext) -> Optional[str]:
        for e in ctx.by_kind("handoff_failed"):
            self._fail_ticks.append(e.tick)
        floor = ctx.tick - self.window_ticks
        self._fail_ticks = [t for t in self._fail_ticks if t >= floor]
        if len(self._fail_ticks) >= self.threshold:
            return (f"{len(self._fail_ticks)} handoff failures within "
                    f"{self.window_ticks} ticks")
        return None


class SloBurnRule(Rule):
    """An SLO target burning for ``streak_ticks`` consecutive
    evaluations — past the flap filter, this is a real regression."""

    name = "slo_burn"
    severity = SEV_WARNING

    def __init__(self, metric: str = "slo.firing_streak",
                 streak_ticks: int = 5):
        self.metric = metric
        self.streak_ticks = int(streak_ticks)

    def update(self, ctx: RuleContext) -> Optional[str]:
        if ctx.ts is None:
            return None
        streak = ctx.ts.latest(self.metric)
        if streak is not None and streak >= self.streak_ticks:
            return (f"SLO firing streak {streak:g} >= "
                    f"{self.streak_ticks} evaluations")
        return None


class ReformBackoffEscalationRule(Rule):
    """A replica failing to re-form repeatedly with rising backoff is
    on the road to quarantine — flag it before the supervisor gives
    up."""

    name = "reform_backoff"
    severity = SEV_WARNING

    def __init__(self, failures: int = 2):
        self.failures = int(failures)
        self._streak: Dict[str, List[float]] = {}

    def update(self, ctx: RuleContext) -> Optional[str]:
        for e in ctx.by_kind("replica_reformed"):
            self._streak.pop(e.subject, None)  # success resets
        for e in ctx.by_kind("reform_failed"):
            backoffs = self._streak.setdefault(e.subject, [])
            backoffs.append(float(e.detail.get("backoff", 0.0)))
        for subject in sorted(self._streak):
            backoffs = self._streak[subject]
            if len(backoffs) >= self.failures \
                    and backoffs[-1] >= backoffs[0]:
                return (f"{subject}: {len(backoffs)} re-form failures, "
                        f"backoff {backoffs[0]:g} -> {backoffs[-1]:g}")
        return None


class ReplicaOutageRule(Rule):
    """A replica detected dead or slot-leaked.  The ``latency`` detect
    reason is EXCLUDED: it is EWMA-of-wall-time driven, and an
    incident stream that depends on host timing would break bundle
    digest equality across same-seed replays."""

    name = "replica_outage"
    severity = SEV_CRITICAL

    #: detect reasons that replay deterministically
    DETERMINISTIC_REASONS = ("dead", "slot_leak")

    def update(self, ctx: RuleContext) -> Optional[str]:
        hits = [e for e in ctx.by_kind("replica_detect")
                if e.detail.get("reason") in self.DETERMINISTIC_REASONS]
        if not hits:
            return None
        parts = sorted(
            f"{e.subject} ({e.detail.get('reason')})" for e in hits)
        return f"replica outage: {', '.join(parts)}"


def default_rules() -> List[Rule]:
    """The rule catalog, default thresholds."""
    return [
        SteadyStateRecompileRule(),
        CounterRegressionRule(),
        QueueDepthSpikeRule(),
        QuarantineRule(),
        HandoffFailureStreakRule(),
        SloBurnRule(),
        ReformBackoffEscalationRule(),
        ReplicaOutageRule(),
    ]


class Incident:
    """One opened anomaly: which rule fired, how bad, when it opened
    and (once quiet) closed, plus the postmortem bundle digest stamped
    at open time."""

    def __init__(self, incident_id: str, rule: str, severity: str,
                 opened_tick: int, reason: str):
        self.incident_id = incident_id
        self.rule = rule
        self.severity = severity
        self.opened_tick = int(opened_tick)
        self.closed_tick: Optional[int] = None
        self.reason = reason
        self.last_fire_tick = int(opened_tick)
        self.bundle_digest: Optional[str] = None

    @property
    def open(self) -> bool:
        return self.closed_tick is None

    def det_dict(self) -> Dict[str, Any]:
        """Replay-deterministic projection (explicit key inclusion —
        no wall times exist on an incident by construction)."""
        return {
            "incident_id": self.incident_id,
            "rule": self.rule,
            "severity": self.severity,
            "opened_tick": self.opened_tick,
            "closed_tick": self.closed_tick,
            "reason": self.reason,
        }

    def to_dict(self) -> Dict[str, Any]:
        out = self.det_dict()
        out["open"] = self.open
        out["bundle_digest"] = self.bundle_digest
        return out


class IncidentEngine:
    """Runs the rule catalog once per tick over the recorder cursor.

    At most one incident is open per rule at a time; an open incident
    closes after ``quiet_ticks`` consecutive evaluations in which its
    rule did not fire.  ``evaluate`` returns (opened, closed) so the
    caller (the fleet's observability tail) can snapshot bundles and
    bump counters — the engine itself never touches fleet state.
    """

    def __init__(self, recorder: Any, timeseries: Any = None,
                 rules: Optional[List[Rule]] = None, *,
                 quiet_ticks: int = 8, max_closed: int = 32):
        if quiet_ticks < 1:
            raise ValueError(
                f"quiet_ticks must be >= 1, got {quiet_ticks}")
        self.recorder = recorder
        self.timeseries = timeseries
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.quiet_ticks = int(quiet_ticks)
        # cadence resolved once — evaluate() runs in the serving tick
        # loop and must not re-read rule attributes per tick
        self._cadence = tuple(
            (rule, max(int(getattr(rule, "every", 1)), 1))
            for rule in self.rules)
        self._cursor = recorder.seq if recorder is not None else 0
        self._open: Dict[str, Incident] = {}
        self.closed: deque = deque(maxlen=max_closed)
        self.opened_total = 0   # counter
        self.closed_total = 0   # counter
        self.evaluations = 0    # counter

    @property
    def open_incidents(self) -> List[Incident]:
        return [self._open[name] for name in sorted(self._open)]

    @property
    def open_count(self) -> int:
        return len(self._open)

    def worst_open_severity(self) -> Optional[str]:
        worst = None
        for inc in self._open.values():
            if worst is None or SEVERITY_RANK.get(inc.severity, 0) \
                    > SEVERITY_RANK.get(worst, 0):
                worst = inc.severity
        return worst

    def evaluate(self, tick: int
                 ) -> Tuple[List[Incident], List[Incident]]:
        """One detection pass; returns (newly opened, newly closed)."""
        events = []
        if self.recorder is not None:
            events = self.recorder.events_since(self._cursor)
            self._cursor = self.recorder.seq
        if events:
            # incident-lifecycle events are the engine's own output; a
            # rule must never fire on them or detection feeds back on
            # itself
            events = [e for e in events
                      if e.kind not in ("incident_opened",
                                        "incident_closed")]
        ctx = RuleContext(tick, events, self.timeseries)
        self.evaluations += 1
        opened: List[Incident] = []
        closed: List[Incident] = []
        tick = int(tick)
        for rule, every in self._cadence:
            if tick % every:
                continue  # off-cadence: fire AND close wait for the
                #           rule's next evaluated tick (deterministic —
                #           cadence is tick-arithmetic, never wall time)
            reason = rule.update(ctx)
            current = self._open.get(rule.name)
            if reason is not None:
                if current is None:
                    self.opened_total += 1
                    incident = Incident(
                        incident_id=(f"{rule.name}"
                                     f"-t{int(tick):06d}"
                                     f"-n{self.opened_total:04d}"),
                        rule=rule.name, severity=rule.severity,
                        opened_tick=tick, reason=reason)
                    self._open[rule.name] = incident
                    opened.append(incident)
                else:
                    current.last_fire_tick = tick
            elif current is not None \
                    and tick - current.last_fire_tick >= self.quiet_ticks:
                current.closed_tick = tick
                del self._open[rule.name]
                self.closed.append(current)
                self.closed_total += 1
                closed.append(current)
        return opened, closed

    def incidents_json(self) -> Dict[str, Any]:
        """The ``/incidents`` exporter payload: open + recently
        closed."""
        return {
            "open": [i.to_dict() for i in self.open_incidents],
            "closed": [i.to_dict() for i in self.closed],
            "opened_total": self.opened_total,
            "closed_total": self.closed_total,
        }

    def snapshot(self) -> Dict[str, Any]:
        return {
            "incidents_opened": self.opened_total,
            "incidents_closed": self.closed_total,
            "incidents_open": len(self._open),
            "incident_evaluations": self.evaluations,
        }

    FIELD_TYPES = {
        "incidents_opened": "counter",
        "incidents_closed": "counter",
        "incidents_open": "gauge",
        "incident_evaluations": "counter",
    }


# --------------------------------------------------------------------------
# postmortem bundles
# --------------------------------------------------------------------------

def build_bundle(incident: Incident, recorder: Any, *,
                 flight_events: int = 256,
                 metrics_summary: Optional[Dict[str, Any]] = None,
                 trace_slice: Optional[List[Dict[str, Any]]] = None,
                 healthz: Optional[Dict[str, Any]] = None,
                 topology: Optional[Dict[str, Any]] = None,
                 ledger_audit: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """One self-contained postmortem artifact for an incident: the
    last-N flight events (deterministic projection), the metrics
    summary window, the trace slice, the health verdict, the fleet
    topology, and the disagg ledger audit when present — stamped with
    its own digest (over the replay-deterministic subset only)."""
    bundle: Dict[str, Any] = {
        "schema": BUNDLE_SCHEMA,
        "incident": incident.det_dict(),
        "flight_log": recorder.deterministic_log(flight_events)
        if recorder is not None else [],
        "metrics": metrics_summary or {},
        "trace": trace_slice or [],
        "healthz": healthz or {},
        "topology": topology or {},
        "ledger_audit": ledger_audit or {},
    }
    bundle["digest"] = bundle_digest(bundle)
    incident.bundle_digest = bundle["digest"]
    bundle["incident"] = incident.det_dict()  # refresh is a no-op; keep order
    return bundle


def deterministic_bundle_view(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """The digest-covered subset of a bundle: incident + flight log +
    topology.  Metrics and trace slices carry wall timestamps by
    construction and are deliberately outside the identity."""
    return {key: bundle.get(key) for key in _BUNDLE_DIGEST_KEYS}


def bundle_digest(bundle: Dict[str, Any]) -> str:
    """sha256 over the canonical JSON of the deterministic view —
    equal across same-seed replays."""
    blob = json.dumps(deterministic_bundle_view(bundle), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


# --------------------------------------------------------------------------
# cause-chain heuristic
# --------------------------------------------------------------------------

#: kind -> causal stage.  The chain reads: a fault landed, it impacted
#: the fleet, remediation ran, recovery settled.
_STAGE_OF_KIND = {
    "fault_applied": "fault",
    "replica_detect": "impact",
    "handoff_failed": "impact",
    "swap_corrupt": "impact",
    "recompile": "impact",
    "replica_drain": "remediation",
    "replica_migrate": "remediation",
    "reform_failed": "remediation",
    "replica_reformed": "remediation",
    "replica_removed": "remediation",
    "replica_retired": "remediation",
    "scale_up": "remediation",
    "scale_down": "remediation",
    "handoff_delivered": "remediation",
    "recovery_settled": "settled",
}

_STAGE_ORDER = ("fault", "impact", "remediation", "settled")


def _event_field(event: Any, name: str, default: Any = None) -> Any:
    """Events arrive as FlightEvent objects (live) or det-dicts (from
    a JSON bundle); read a field either way."""
    if isinstance(event, dict):
        return event.get(name, default)
    return getattr(event, name, default)


def cause_chain(events: List[Any]) -> List[Dict[str, Any]]:
    """The fault -> impact -> remediation -> settled skeleton of an
    event window: each causally-staged event in tick order, stages
    only advancing monotonically after the first fault.  Events before
    the first ``fault_applied`` are warmup noise and excluded; a chain
    with no fault starts at its first impact-stage event."""
    staged = []
    for event in events:
        kind = _event_field(event, "kind")
        stage = _STAGE_OF_KIND.get(kind)
        if stage is None:
            continue
        staged.append({
            "stage": stage,
            "tick": _event_field(event, "tick", 0),
            "lane": _event_field(event, "lane", ""),
            "kind": kind,
            "subject": _event_field(event, "subject", ""),
        })
    staged.sort(key=lambda s: (s["tick"],
                               _STAGE_ORDER.index(s["stage"])))
    anchor = next((i for i, s in enumerate(staged)
                   if s["stage"] == "fault"), None)
    if anchor is None:
        anchor = 0
    return staged[anchor:]


def chain_stages(chain: List[Dict[str, Any]]) -> List[str]:
    """The distinct stages present in a chain, causal order."""
    present = {link["stage"] for link in chain}
    return [s for s in _STAGE_ORDER if s in present]


__all__ = [
    "SEV_INFO", "SEV_WARNING", "SEV_CRITICAL", "SEVERITY_RANK",
    "BUNDLE_SCHEMA",
    "Rule", "RuleContext",
    "SteadyStateRecompileRule", "CounterRegressionRule",
    "QueueDepthSpikeRule", "QuarantineRule",
    "HandoffFailureStreakRule", "SloBurnRule",
    "ReformBackoffEscalationRule", "ReplicaOutageRule",
    "default_rules",
    "Incident", "IncidentEngine",
    "build_bundle", "deterministic_bundle_view", "bundle_digest",
    "cause_chain", "chain_stages",
]
