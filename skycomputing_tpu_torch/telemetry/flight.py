"""FlightRecorder: the fleet's always-on black box (the port's own
copy of ``skycomputing_tpu/telemetry/flight.py``).

Every subsystem that changes fleet state already keeps its own private
event list — ``FleetSupervisor.events``, ``FleetAutoscaler.events``,
``FaultInjector.event_log()``, the disagg ``HandoffLedger.events``, the
SLO monitor's firing set.  When an incident degrades the fleet those
five surfaces must be hand-correlated after the fact.  The flight
recorder is the single bounded ring they all feed through *sanctioned
taps* (``ServingFleet.step()`` drains each component's event cursor once
per tick — components are never modified to push), so one structure
holds the correlated "what happened" stream.

Determinism contract (the chaos plane's precedent):

- ``FlightEvent`` is frozen and validated at construction: tick is a
  non-negative int, lane and kind come from closed vocabularies,
  subject is a string, detail is a dict with string keys.
- ``clock=`` is injectable and defaults to ``None`` (skydet DET001: no
  ambient wall-clock reads).  When provided, the wall stamp lands in
  ``FlightEvent.wall_s`` — which ``det_dict()`` structurally omits.
- ``deterministic_log()`` / ``digest()`` project every event through
  ``det_dict()``, which excludes wall times and request-routing
  resolution (``_DETAIL_EXCLUDED``), so two same-seed scenario replays
  produce byte-identical logs and equal sha256 digests even though
  request ids are process-global counters.

PURE STDLIB BY CONTRACT: no torch, no numpy, no package-relative imports
— loadable by file path on a bare CI runner (``tools/flight_smoke.py``)
and safe to call from exporter handler threads.
"""

from __future__ import annotations

import hashlib
import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: source lanes — one per subsystem feeding the recorder.  The lane is
#: the correlation axis skyreport renders timelines along.
FLIGHT_LANES = frozenset((
    "fleet",        # incident lifecycle + fleet-level events
    "supervisor",   # detect / drain / migrate / re-form / quarantine
    "autoscaler",   # verified scale decisions + rejections
    "chaos",        # injected faults + recovery settlement
    "disagg",       # KV-handoff ledger transitions
    "slo",          # burn-alert edges
    "serving",      # engine recompiles + swap corruption
))

#: closed event vocabulary, grouped by the lane that emits each kind.
FLIGHT_KINDS = frozenset((
    # chaos
    "fault_applied", "fault_skipped", "recovery_settled",
    # supervisor
    "replica_detect", "replica_drain", "replica_migrate",
    "replica_removed", "replica_retired", "reform_failed",
    "replica_reformed",
    # autoscaler
    "scale_up", "scale_down", "scale_rejected",
    # disagg ledger
    "handoff_enqueued", "handoff_delivered", "handoff_failed",
    # slo
    "slo_alert", "slo_clear",
    # serving engine
    "recompile", "swap_corrupt",
    # incident plane (fleet lane)
    "incident_opened", "incident_closed",
))

#: detail keys that never reach a deterministic view: wall-clock values
#: and request-routing resolution (request ids are process-global
#: counters, so two same-seed replays in one process disagree on them;
#: supervisor ``score`` is EWMA-of-wall-latency derived).
_DETAIL_EXCLUDED = frozenset((
    "req_id", "request_id", "resolved", "timestamp", "ts",
    "wall_elapsed_s", "wall_s", "wall_time", "score", "tick_s",
))

_DEFAULT_CAPACITY = 2048


def _det_value(value: Any) -> Any:
    """A value projected for a deterministic view: dicts filtered
    recursively, sequences element-wise, scalars/strings as-is, and
    anything exotic collapsed to ``repr`` (stable for stdlib types)."""
    if isinstance(value, dict):
        return _det_detail(value)
    if isinstance(value, (list, tuple)):
        return [_det_value(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return repr(value)


def _det_detail(detail: Dict[str, Any]) -> Dict[str, Any]:
    """A detail dict with wall/routing keys projected out, built in
    sorted key order (DET003: fold order is content-determined)."""
    out: Dict[str, Any] = {}
    for key in sorted(detail):
        if key in _DETAIL_EXCLUDED:
            continue
        out[key] = _det_value(detail[key])
    return out


@dataclass(frozen=True)
class FlightEvent:
    """One structured black-box entry: what happened (``kind``), where
    (``lane`` / ``subject``), when (``tick``), and with what payload
    (``detail``).  ``wall_s`` is observability-only and never reaches
    ``det_dict()``."""

    tick: int
    lane: str
    kind: str
    subject: str = ""
    detail: Dict[str, Any] = field(default_factory=dict)
    wall_s: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.tick, bool) or not isinstance(self.tick, int):
            raise TypeError(f"tick must be an int, got {self.tick!r}")
        if self.tick < 0:
            raise ValueError(f"tick must be >= 0, got {self.tick}")
        if self.lane not in FLIGHT_LANES:
            raise ValueError(
                f"unknown lane {self.lane!r}; lanes: "
                f"{', '.join(sorted(FLIGHT_LANES))}")
        if self.kind not in FLIGHT_KINDS:
            raise ValueError(
                f"unknown kind {self.kind!r}; kinds: "
                f"{', '.join(sorted(FLIGHT_KINDS))}")
        if not isinstance(self.subject, str):
            raise TypeError(
                f"subject must be a str, got {self.subject!r}")
        if not isinstance(self.detail, dict):
            raise TypeError(
                f"detail must be a dict, got {type(self.detail).__name__}")
        for key in self.detail:
            if not isinstance(key, str):
                raise TypeError(
                    f"detail keys must be str, got {key!r}")

    def det_dict(self) -> Dict[str, Any]:
        """The replay-deterministic projection: explicit key inclusion
        (``wall_s`` omitted structurally), detail filtered through
        ``_det_detail``."""
        return {
            "tick": self.tick,
            "lane": self.lane,
            "kind": self.kind,
            "subject": self.subject,
            "detail": _det_detail(self.detail),
        }


class FlightRecorder:
    """Bounded ring of :class:`FlightEvent` with a monotonic sequence.

    ``seq`` counts every event ever recorded; the ring keeps the newest
    ``capacity``.  ``events_since(seq)`` is the cursor primitive the
    incident engine drains with — eviction can only *shorten* what a
    lagging cursor sees, never reorder it.
    """

    FIELD_TYPES = {
        "flight_recorded": "counter",
        "flight_evicted": "counter",
        "flight_buffered": "gauge",
        "flight_capacity": "gauge",
    }

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._clock = clock
        self.recorded = 0   # counter: events ever recorded (== seq)
        self.evicted = 0    # counter: events pushed out of the ring

    @property
    def seq(self) -> int:
        """Monotonic sequence number == events recorded so far."""
        return self.recorded

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, tick: int, lane: str, kind: str, subject: str = "",
               detail: Optional[Dict[str, Any]] = None) -> FlightEvent:
        """Validate + append one event; returns the frozen event."""
        event = FlightEvent(
            tick=tick, lane=lane, kind=kind, subject=subject,
            detail=dict(detail) if detail else {},
            wall_s=self._clock() if self._clock is not None else None,
        )
        if len(self._ring) == self.capacity:
            self.evicted += 1
        self._ring.append(event)
        self.recorded += 1
        return event

    def events(self, last: Optional[int] = None) -> List[FlightEvent]:
        """The newest ``last`` buffered events (all when None)."""
        out = list(self._ring)
        if last is not None:
            out = out[-int(last):]
        return out

    def events_since(self, seq: int) -> List[FlightEvent]:
        """Events with global sequence >= ``seq`` still in the ring
        (oldest first).  A cursor that lagged past eviction silently
        resumes at the ring's oldest survivor."""
        oldest = self.recorded - len(self._ring)
        skip = max(0, seq - oldest)
        if skip >= len(self._ring):
            return []
        return list(self._ring)[skip:]

    def deterministic_log(self, last: Optional[int] = None
                          ) -> List[Dict[str, Any]]:
        """Replay-deterministic projection of the buffered events
        (newest ``last``, or all): wall times and routing resolution
        excluded, so same-seed replays are byte-identical."""
        return [e.det_dict() for e in self.events(last)]

    def digest(self, last: Optional[int] = None) -> str:
        """sha256 over the canonical JSON of ``deterministic_log()`` —
        the whole-flight identity same-seed replays must agree on."""
        blob = json.dumps(self.deterministic_log(last), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()

    def snapshot(self) -> Dict[str, Any]:
        """Counter-disciplined metrics view (every numeric
        field classified in ``FIELD_TYPES``)."""
        return {
            "flight_recorded": self.recorded,
            "flight_evicted": self.evicted,
            "flight_buffered": len(self._ring),
            "flight_capacity": self.capacity,
        }


__all__ = [
    "FLIGHT_LANES",
    "FLIGHT_KINDS",
    "FlightEvent",
    "FlightRecorder",
]
