"""ScenarioPlayer: drive a fleet (or bare engine) through a scenario
(the port of ``skycomputing_tpu/workload/player.py``).

The scenario core (:mod:`.scenario`) is pure stdlib and only *describes*
traffic; this module is the actuator that replays a trace against a
real target, tick for tick:

- materializes each :class:`~.scenario.Arrival` into a
  :class:`~..serving.batcher.Request` at exactly its arrival tick;
- submits through whichever surface the target has — a
  :class:`~..fleet.ServingFleet` (priority-aware ``submit`` returning
  an ``AdmitDecision``) or a bare :class:`~..serving.ServingEngine`
  (``submit`` that raises ``QueueFullError`` on a full bounded queue);
  the target is DUCK-TYPED so this module never imports the fleet
  (workload sits beside it in the layer graph, not above it);
- records one :class:`PlayerVerdict` per arrival — the admission
  outcome at submit time plus the terminal status after the run — so
  "what happened to every request" is an artifact, not a printf;
- optionally samples a caller-provided probe every tick
  (``sample_fn``), which is how the autoscaler bench captures the
  replica-count timeline without the player knowing what a replica is.

The player NEVER consumes the scenario's rng — the trace is fully
materialized before the first tick — so two players over the same
scenario see byte-identical arrivals regardless of what the target
does with them (the determinism contract
``tests/test_torch_workload.py`` pins)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..serving.batcher import (
    FINISHED,
    QueueFullError,
    REJECTED,
    Request,
)
from .scenario import Arrival, Scenario, trace_digest


@dataclass
class PlayerVerdict:
    """One arrival's fate: admission outcome + terminal status."""

    arrival: Arrival
    request: Request
    admitted: bool
    reason: Optional[str] = None
    retry_after_s: Optional[float] = None
    replica: Optional[str] = None
    #: extra context a target attached to the decision (e.g. the
    #: bounded queue's depth on a bare-engine reject — a COUNT, which
    #: must never masquerade as the seconds-valued retry hint)
    detail: Dict[str, Any] = field(default_factory=dict)

    @property
    def finished(self) -> bool:
        return self.request.status == FINISHED

    def to_dict(self) -> Dict[str, Any]:
        r = self.request
        return dict(
            request_id=r.request_id,
            tick=self.arrival.tick,
            phase=self.arrival.phase,
            priority=self.arrival.priority,
            prompt_len=len(self.arrival.prompt),
            new_tokens=self.arrival.new_tokens,
            admitted=self.admitted,
            reason=self.reason,
            retry_after_s=self.retry_after_s,
            replica=self.replica,
            detail=dict(self.detail),
            status=r.status,
            generated=len(r.tokens),
            ttft_s=r.ttft_s(),
            tpot_s=r.tpot_s(),
        )


@dataclass
class PlayerReport:
    """Everything one replay produced, in artifact-ready form."""

    scenario: str
    seed: int
    digest: str
    ticks_run: int = 0
    #: stamped by the CALLER (benches) around :meth:`ScenarioPlayer.
    #: play` — the player itself never times across ``step()`` calls
    #: (engine/fleet steps sync internally, but that contract belongs
    #: to the target)
    wall_s: float = 0.0
    verdicts: List[PlayerVerdict] = field(default_factory=list)
    #: one ``sample_fn`` result per tick (empty when no probe given)
    timeline: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def admitted(self) -> List[PlayerVerdict]:
        return [v for v in self.verdicts if v.admitted]

    @property
    def rejected(self) -> List[PlayerVerdict]:
        return [v for v in self.verdicts if not v.admitted]

    @property
    def finished(self) -> List[PlayerVerdict]:
        return [v for v in self.verdicts if v.finished]

    def summary(self) -> Dict[str, Any]:
        """Per-phase and per-priority rollup (pure host math)."""

        def pct(vals: List[float], q: float) -> Optional[float]:
            vals = sorted(v for v in vals if v is not None)
            if not vals:
                return None
            rank = max(0, min(len(vals) - 1,
                              round(q / 100.0 * (len(vals) - 1))))
            return float(vals[int(rank)])

        def rollup(verdicts: List[PlayerVerdict]) -> Dict[str, Any]:
            fin = [v for v in verdicts if v.finished]
            return dict(
                arrivals=len(verdicts),
                admitted=sum(1 for v in verdicts if v.admitted),
                rejected=sum(1 for v in verdicts if not v.admitted),
                finished=len(fin),
                ttft_p50_s=pct([v.request.ttft_s() for v in fin], 50),
                ttft_p95_s=pct([v.request.ttft_s() for v in fin], 95),
                tpot_p50_s=pct([v.request.tpot_s() for v in fin], 50),
                tpot_p95_s=pct([v.request.tpot_s() for v in fin], 95),
            )

        phases: Dict[str, List[PlayerVerdict]] = {}
        priorities: Dict[str, List[PlayerVerdict]] = {}
        reasons: Dict[str, int] = {}
        for v in self.verdicts:
            phases.setdefault(v.arrival.phase, []).append(v)
            priorities.setdefault(v.arrival.priority, []).append(v)
            if not v.admitted and v.reason:
                reasons[v.reason] = reasons.get(v.reason, 0) + 1
        return dict(
            scenario=self.scenario, seed=self.seed, digest=self.digest,
            ticks_run=self.ticks_run, wall_s=self.wall_s,
            total=rollup(self.verdicts),
            rejected_by_reason=reasons,
            phases={name: rollup(vs) for name, vs in phases.items()},
            priorities={name: rollup(vs)
                        for name, vs in priorities.items()},
        )


class ScenarioPlayer:
    """Tick-driven scenario replay against a fleet or bare engine."""

    def __init__(
        self,
        scenario: Scenario,
        target: Any,
        *,
        priority_aware: Optional[bool] = None,
        deadline_s: Optional[float] = None,
        max_ticks: int = 100_000,
        sample_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    ):
        self.scenario = scenario
        self.target = target
        # a fleet exposes admission control; a bare engine does not —
        # the one structural difference the player cares about
        self.priority_aware = (
            bool(getattr(target, "admission", None) is not None)
            if priority_aware is None else bool(priority_aware)
        )
        self.deadline_s = deadline_s
        self.max_ticks = int(max_ticks)
        self.sample_fn = sample_fn
        #: the materialized trace (computed ONCE, before any ticking)
        self.arrivals: List[Arrival] = scenario.arrivals()

    def _submit(self, arrival: Arrival) -> PlayerVerdict:
        request = Request(
            prompt=np.asarray(arrival.prompt, np.int32),
            max_new_tokens=arrival.new_tokens,
        )
        if self.priority_aware:
            decision = self.target.submit(
                request, priority=arrival.priority,
                deadline_s=self.deadline_s,
            )
            return PlayerVerdict(
                arrival=arrival, request=request,
                admitted=decision.admitted, reason=decision.reason,
                retry_after_s=decision.retry_after_s,
                replica=decision.replica,
            )
        try:
            self.target.submit(request)
        except QueueFullError as exc:
            request.status = REJECTED
            # a bare engine has no admission controller to mint a
            # Retry-After estimate; the queue depth it reports is a
            # COUNT and lands in detail, never in the seconds field
            return PlayerVerdict(
                arrival=arrival, request=request, admitted=False,
                reason="queue_full",
                detail=dict(queue_depth=exc.queue_depth),
            )
        return PlayerVerdict(arrival=arrival, request=request,
                             admitted=True)

    def play(self, *, drain: bool = True) -> PlayerReport:
        """Replay the whole trace; with ``drain`` (default) keep
        ticking until the target reports no work left, so every
        admitted request reaches a terminal status."""
        report = PlayerReport(
            scenario=self.scenario.name, seed=self.scenario.seed,
            # hash the trace ALREADY materialized at construction —
            # scenario.digest() would regenerate every token just to
            # hash it
            digest=trace_digest(self.arrivals),
        )
        i = 0
        tick = 0
        while i < len(self.arrivals) or (drain
                                         and self.target.has_work()):
            while (i < len(self.arrivals)
                   and self.arrivals[i].tick <= tick):
                report.verdicts.append(self._submit(self.arrivals[i]))
                i += 1
            self.target.step()
            if self.sample_fn is not None:
                report.timeline.append(self.sample_fn())
            tick += 1
            if tick > self.max_ticks:  # pragma: no cover - liveness
                raise RuntimeError(
                    f"scenario {self.scenario.name!r} did not drain in "
                    f"{self.max_ticks} ticks "
                    f"({i}/{len(self.arrivals)} submitted)"
                )
        report.ticks_run = tick
        return report


__all__ = ["PlayerReport", "PlayerVerdict", "ScenarioPlayer"]
