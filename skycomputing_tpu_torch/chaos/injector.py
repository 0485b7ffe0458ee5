"""FaultInjector: the actuator that fires a FaultPlan at a live fleet
(the port of ``skycomputing_tpu/chaos/injector.py``).

The plan (:mod:`.plan`) is the value; this is the arm.  The fleet loop
already polls ``fleet.fault_injector.on_tick(fleet)`` FIRST in
``step()`` — before limbo redispatch, replica ticks, and the
supervisor — so an event scheduled at tick N lands before ANY of tick
N's work, exactly like the dynamics-plane ``FleetFaultInjector`` it
generalizes.  Composition with the workload plane is one assignment:

    fleet.fault_injector = FaultInjector(get_fault_plan("reform_flap"))
    ScenarioPlayer(scenario, fleet, sample_fn=make_probe(fleet)).play()

**Sanctioned hooks only.**  Every kind lowers to one public fault
surface — ``replica.crash()`` / ``inject_stall`` / ``fail_next_builds``,
``engine.corrupt_swap_record``, ``admission.blip_active`` — never a
monkeypatch, so an injected run can only reach states the real system
can.  Before the first event fires, the plan is re-verified through
``analysis.plan_check.verify_fault_plan`` (verify-then-apply: a
malformed plan dies before any mutation, and the checker is imported
lazily at decision time, the autoscaler idiom).

**Honest bookkeeping.**  Every application appends one entry to the
event log — including SKIPS (a selector that resolves to nothing, a
corruption with no record to poison even under force) with
``ok=False`` and a note, because a fault that silently didn't happen
poisons every downstream invariant.  The one deliberate exception to
exact-tick firing: a ``pending_removal`` event whose tick passes with
no drain in flight ARMS (logged) and fires at the first later tick
the autoscaler is mid-removal — "kill the next drain" is the only
honest way to hit a window whose exact tick the plan cannot know.  A
``handoff_corruption`` that finds nothing in flight arms the same way
and fires at the first tick a handoff record IS mid-flight (the
KV-handoff window is one tick wide by construction — "corrupt the
next handoff" is the only honest way to hit it).  The log carries NO
request ids or wall times (ids mint from a process-global counter), and
its ``deterministic_log()`` projection — everything except which live
replica a load-based selector resolved to — is byte-identical across
same-seed runs.  Applied faults count ``FleetStats.faults_injected``
and emit ``fault_inject`` trace instants; each fault burst opens an async
``recovery`` arc on the chaos lane that closes — counting
``recoveries_completed`` — when the fleet next reaches a settled state
(every replica HEALTHY or RETIRED, nobody crashed-but-undetected, no
migration limbo, at least one healthy replica, no live blip).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..fleet.replica import RETIRED
from ..telemetry import get_tracer
from ..utils import Logger
from .invariants import fleet_settled
from .plan import (
    ADMISSION_BLIP,
    HANDOFF_CORRUPTION,
    REFORM_FAILURE,
    REPLICA_CRASH,
    STAGE_SLOWDOWN,
    SWAP_CORRUPTION,
    FaultEvent,
    FaultPlan,
)


class FaultInjector:
    """Apply a :class:`~.plan.FaultPlan`'s events at exact fleet ticks
    through sanctioned hooks, with a replayable event log."""

    def __init__(self, plan: FaultPlan,
                 logger: Optional[Logger] = None):
        self.plan = plan
        self._logger = logger or Logger()
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for event in plan.resolved_events():
            self._by_tick.setdefault(event.tick, []).append(event)
        self._verified = False
        self._blip_clear_tick: Optional[int] = None
        #: ``pending_removal`` events whose tick passed with no drain
        #: in flight: they stay armed and fire at the FIRST later tick
        #: where the autoscaler is mid-removal (both the arming and the
        #: eventual firing are logged — honest bookkeeping)
        self._armed: List[FaultEvent] = []
        #: the replayable record: one dict per event APPLICATION
        #: attempt, in firing order — no request ids, no wall times
        self.applied: List[Dict[str, Any]] = []
        #: tick of the most recent successfully applied fault (the
        #: auditor's recovery-budget anchor); None before any fired
        self.last_fault_tick: Optional[int] = None
        #: closed recovery arcs: (fault burst's last tick, settled
        #: tick) pairs — time-to-healthy as data
        self.recoveries: List[Dict[str, int]] = []
        self._recovery_open = False
        self._arc_id = 0

    # --- plan surface -------------------------------------------------------
    def event_log(self) -> List[Dict[str, Any]]:
        """The applications so far (copy), including which live
        replica each selector resolved to."""
        return [dict(e) for e in self.applied]

    def deterministic_log(self) -> List[Dict[str, Any]]:
        """The event log minus ``resolved`` — the determinism artifact
        two same-seed runs compare byte for byte.  ``resolved`` is
        excluded deliberately: load-based selection (the autoscaler's
        scale-down victim a ``pending_removal`` kill lands on) reads
        wall-clock-sensitive routing state the chaos plane does not
        control; everything the PLAN controls — which events fired at
        which ticks, with which outcome — is replayable."""
        return [{k: e[k] for k in ("tick", "kind", "target", "params",
                                   "duration", "ok", "note")}
                for e in self.applied]

    def _verify(self) -> None:
        # verify-then-apply, lazily: the schema checker is an analysis
        # import pulled in at decision time only (keeping chaos's
        # import graph to serving/fleet/telemetry at module load)
        from ..analysis.plan_check import verify_fault_plan
        problems = verify_fault_plan(self.plan.to_dict())
        if problems:
            raise ValueError(
                f"fault plan {self.plan.name!r} failed verification: "
                f"{problems}"
            )
        self._verified = True

    # --- the tick hook ------------------------------------------------------
    def on_tick(self, fleet) -> None:
        """Called FIRST in ``ServingFleet.step()``: settle any open
        recovery arc, lift expired blips, then fire this tick's
        events."""
        if not self._verified:
            self._verify()
        if (self._blip_clear_tick is not None
                and fleet.tick >= self._blip_clear_tick):
            fleet.admission.blip_active = False
            self._blip_clear_tick = None
        # recovery settles BEFORE this tick's events fire, so a burst
        # landing on an already-settled fleet opens a fresh arc
        # (fleet_settled is the auditor's own predicate — the arc and
        # the gate agree by construction)
        if self._recovery_open and fleet_settled(fleet):
            self._close_recovery(fleet)
        if self._armed:
            # at most ONE armed event fires per tick: a drain window is
            # one removal, and killing the same draining replica twice
            # proves nothing — the rest stay armed for the next drain
            for i, event in enumerate(self._armed):
                if not self._armed_ready(fleet, event):
                    continue
                self._armed.pop(i)
                self._apply(fleet, event)
                break
        for event in self._by_tick.get(fleet.tick, ()):
            self._apply(fleet, event)

    def _close_recovery(self, fleet) -> None:
        self._recovery_open = False
        fleet.stats.recoveries_completed += 1
        self.recoveries.append(dict(
            fault_tick=int(self.last_fault_tick),
            settled_tick=int(fleet.tick),
        ))
        tracer = get_tracer()
        if tracer is not None:
            tracer.async_end(
                "recovery", tracer.lane("fleet", "chaos"),
                self._arc_id,
                {"fault_tick": self.last_fault_tick,
                 "settled_tick": fleet.tick},
            )

    def _open_recovery(self, fleet) -> None:
        if self._recovery_open:
            return
        self._recovery_open = True
        self._arc_id += 1
        tracer = get_tracer()
        if tracer is not None:
            tracer.async_begin(
                "recovery", tracer.lane("fleet", "chaos"),
                self._arc_id, {"tick": fleet.tick},
            )

    # --- event application --------------------------------------------------
    def _armed_ready(self, fleet, event: FaultEvent) -> bool:
        """Can this ARMED event fire now?  ``pending_removal`` needs a
        drain in flight; ``handoff_corruption`` needs a handoff record
        mid-flight (the one-tick PENDING window)."""
        if event.kind == HANDOFF_CORRUPTION:
            ledger = getattr(fleet, "ledger", None)
            return ledger is not None and bool(ledger.pending())
        _, note = self._resolve(fleet, event)
        return note is None

    def _resolve(self, fleet, event: FaultEvent):
        """(replica-or-None, note): the live target, or why there is
        none.  ``fleet``-targeted events resolve to (None, None)."""
        target = event.target
        if target == "fleet":
            return None, None
        if target == "pending_removal":
            for r in fleet.replicas:
                if r.pending_removal and r.state != RETIRED:
                    return r, None
            return None, "no replica is mid-removal"
        if target.startswith("index:"):
            idx = int(target[len("index:"):])
            if idx >= len(fleet.replicas):
                return None, f"index {idx} out of range"
            replica = fleet.replicas[idx]
        else:  # name:X (plan validation allows nothing else)
            name = target[len("name:"):]
            replica = next(
                (r for r in fleet.replicas if r.name == name), None
            )
            if replica is None:
                return None, f"no replica named {name!r}"
        if replica.state == RETIRED:
            return None, "target is retired"
        return replica, None

    def _apply(self, fleet, event: FaultEvent) -> None:
        params = event.params_dict()
        replica, note = self._resolve(fleet, event)
        ok = note is None
        if (not ok and event.target == "pending_removal"
                and event not in self._armed):
            # a mid-drain kill with no drain in flight ARMS instead of
            # dying: it fires at the next tick a removal is draining
            # (two-phase scale-down guarantees every removal has one)
            self._armed.append(event)
            note = f"{note}; armed"
        if ok:
            if event.kind == REPLICA_CRASH:
                replica.crash()
            elif event.kind == STAGE_SLOWDOWN:
                replica.inject_stall(
                    params["seconds"],
                    clear_at_tick=fleet.tick + event.duration,
                )
            elif event.kind == REFORM_FAILURE:
                replica.fail_next_builds(params["builds"])
            elif event.kind == SWAP_CORRUPTION:
                if replica.engine is None:
                    ok, note = False, "target has no engine"
                else:
                    try:
                        rid = replica.engine.corrupt_swap_record(
                            force=params.get("force", True)
                        )
                    except ValueError as exc:
                        ok, note = False, str(exc)
                    else:
                        if rid is None:
                            ok = False
                            note = "no swap record to corrupt"
            elif event.kind == HANDOFF_CORRUPTION:
                # duck-typed: only a disagg fleet exposes the hook, and
                # an honest skip beats a monkeypatch on a plain fleet
                hook = getattr(fleet, "corrupt_handoff", None)
                if hook is None:
                    ok, note = False, "fleet has no handoff plane"
                else:
                    try:
                        rid = hook(force=params.get("force", True))
                    except (KeyError, ValueError) as exc:
                        ok, note = False, str(exc)
                    else:
                        if rid is None:
                            ok = False
                            note = "no handoff record to corrupt"
            elif event.kind == ADMISSION_BLIP:
                fleet.admission.blip_active = True
                clear = fleet.tick + event.duration
                self._blip_clear_tick = (
                    clear if self._blip_clear_tick is None
                    else max(self._blip_clear_tick, clear)
                )
            else:  # pragma: no cover - plan validation forbids this
                raise ValueError(
                    f"unsanctioned fault kind {event.kind!r}"
                )
        if (not ok and event.kind == HANDOFF_CORRUPTION
                and note == "no handoff record to corrupt"
                and event not in self._armed):
            # the in-flight window is one tick wide: arm and poison the
            # NEXT handoff instead of dying (a fleet with no handoff
            # plane at all stays an honest skip — it will never fire)
            self._armed.append(event)
            note = f"{note}; armed"
        entry = dict(
            tick=int(fleet.tick), kind=event.kind,
            target=event.target,
            resolved="fleet" if replica is None and ok
            else (replica.name if replica is not None else None),
            params=params, duration=int(event.duration),
            ok=bool(ok), note=note,
        )
        self.applied.append(entry)
        if not ok:
            self._logger.warning(
                f"FaultInjector: {event.kind} at tick {fleet.tick} "
                f"skipped ({note})"
            )
            return
        self.last_fault_tick = int(fleet.tick)
        fleet.stats.faults_injected += 1
        self._open_recovery(fleet)
        tracer = get_tracer()
        if tracer is not None:
            tracer.instant(
                "fault_inject", tracer.lane("fleet", "chaos"),
                {"kind": event.kind, "target": event.target,
                 "resolved": entry["resolved"],
                 "duration": event.duration},
            )
        self._logger.info(
            f"FaultInjector: {event.kind} -> {entry['resolved']} "
            f"at tick {fleet.tick}"
        )


__all__ = ["FaultInjector"]
