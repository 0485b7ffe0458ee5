"""FleetSupervisor: detect sick/dead replicas, migrate, re-form (the port's own
copy of ``skycomputing_tpu/fleet/supervisor.py``).

Detection reuses the trainer's straggler machinery at fleet-tick granularity:

- **heartbeat** — every successful replica tick is a beat; a tick that
  raises :class:`~.replica.ReplicaCrashed` is a miss, and
  ``heartbeat_misses`` consecutive misses declare the replica DEAD
  (the in-process analog of ``PeerHeartbeat``'s timed collective).
- **EWMA health score** — per-replica EWMA of tick wall time against a
  per-era baseline (minimum over the first ``baseline_ticks``
  post-grace observations, the ``SelfHealHook`` idiom: one hiccup must
  not inflate "normal").  ``k_checks`` consecutive checks above
  ``sick_threshold ×`` baseline declare the replica SICK.
- **slot accounting** — occupied KV slots not owned by any running
  request (the ``slot_leak`` fault, or a real free-list bug) declare it
  SICK immediately: leaked capacity never heals by waiting.

Recovery follows the verify-then-apply contract:

1. **drain** — a sick replica is drained gracefully through the
   engine's ``preempt`` contract (token streams provably intact); a
   dead replica's requests are recovered from the fleet ledger (the
   ``Request`` objects carry their committed tokens, so recomputation
   resume is exact).
2. **migrate** — drained requests re-dispatch through the router onto
   survivors; requests no survivor can hold yet park in the fleet's
   migration limbo and re-try every tick.  A request whose resume
   prefix no longer fits any bucket is marked FAILED and counted —
   never silently dropped.
3. **re-form** — the replica rebuilds through the same builder that
   constructed it (worker-manager serving pre-flight included), so an
   infeasible re-allocation is REJECTED by the verifier before any
   state is touched; the rollback is structural — the old fleet state
   was never mutated — and the failure spends the replica's
   ``max_reforms`` budget until it is RETIRED.

Every attempt is an async ``fleet_heal`` trace arc (opened at
detection, ``fleet.drain`` / ``fleet.migrate`` / ``fleet.reform`` spans
inside, closed with the outcome), the self-heal arc convention applied
to the fleet lane.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..telemetry import get_tracer
from ..utils import Logger
from .replica import (
    DEAD,
    DRAINING,
    EVICTED,
    HEALTHY,
    RETIRED,
    EngineReplica,
)

# detection reasons (stable ids in events and trace args)
REASON_DEAD = "dead"
REASON_LATENCY = "latency"
REASON_SLOT_LEAK = "slot_leak"

# heal outcomes
REFORMED = "reformed"
REFORM_FAILED = "reform_failed"
RETIRED_OUT = "retired"


class _Health:
    """Per-replica, per-era health telemetry (reset on re-form)."""

    __slots__ = ("seen", "ewma", "baseline", "baseline_obs", "streak")

    def __init__(self):
        self.seen = 0
        self.ewma: Optional[float] = None
        self.baseline: Optional[float] = None
        self.baseline_obs: List[float] = []
        self.streak = 0


class FleetSupervisor:
    """Health scoring + the drain/migrate/re-form executor."""

    def __init__(
        self,
        *,
        ewma_alpha: float = 0.4,
        sick_threshold: float = 3.0,
        k_checks: int = 2,
        grace_ticks: int = 2,
        baseline_ticks: int = 4,
        heartbeat_misses: int = 2,
        check_every: int = 2,
        max_reforms: int = 2,
        reform_backoff_base: int = 2,
        reform_backoff_cap: int = 32,
        clock: Optional[Callable[[], float]] = None,
        logger: Optional[Logger] = None,
        slo_monitor=None,
    ):
        if check_every < 1 or heartbeat_misses < 1 or k_checks < 1:
            raise ValueError(
                "check_every, heartbeat_misses and k_checks must be >= 1"
            )
        if baseline_ticks < 1:
            raise ValueError("baseline_ticks must be >= 1")
        if reform_backoff_base < 0 or reform_backoff_cap < 0:
            raise ValueError(
                "reform_backoff_base and reform_backoff_cap must be "
                ">= 0"
            )
        self._alpha = float(ewma_alpha)
        self._sick_threshold = float(sick_threshold)
        self._k_checks = int(k_checks)
        self._grace_ticks = int(grace_ticks)
        self._baseline_ticks = int(baseline_ticks)
        self.heartbeat_misses = int(heartbeat_misses)
        self.check_every = int(check_every)
        self.max_reforms = int(max_reforms)
        # exponential backoff between STANDALONE re-form retries (the
        # poll()-driven path for replicas stranded DEAD/EVICTED or
        # finishing a drain): a failed attempt schedules the next one
        # base * 2^(failures-1) ticks out, capped — without this the
        # supervisor hammers a rejecting builder every single poll.
        # heal()'s inline attempt is deliberately NOT gated: fresh
        # detection evidence earns an immediate try.  The clock is
        # injectable (tests drive it deterministically); default is the
        # fleet's own tick counter.
        self.reform_backoff_base = int(reform_backoff_base)
        self.reform_backoff_cap = int(reform_backoff_cap)
        self._clock = clock
        self._next_retry_at: Dict[str, float] = {}
        # quarantine ledger: replicas RETIRED out of the fleet (re-form
        # budget exhausted), kept visible — /healthz and FleetStats
        # surface them so an operator sees WHAT is permanently out and
        # WHY, instead of inferring it from a shrinking replica count
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        self._logger = logger or Logger()
        # optional online-SLO signal (duck-typed like the admission
        # controller's): while any declared SLO burns, the sick-check
        # runs EVERY tick instead of every check_every — an alerting
        # fleet earns a closer look, not a scheduled one
        self.slo_monitor = slo_monitor
        self._health: Dict[str, _Health] = {}
        self._reform_attempts: Dict[str, int] = {}
        self._arc_id = 0
        self.events: List[Dict[str, Any]] = []

    # --- telemetry ----------------------------------------------------------
    def _h(self, replica: EngineReplica) -> _Health:
        got = self._health.get(replica.name)
        if got is None:
            got = self._health[replica.name] = _Health()
        return got

    def observe_tick(self, replica: EngineReplica,
                     tick_s: float) -> None:
        """Fold one successful tick's wall time into the replica's
        health score.  The first ``grace_ticks`` of an era are compile
        warmup and are skipped, exactly like ``SelfHealHook``."""
        h = self._h(replica)
        h.seen += 1
        if h.seen <= self._grace_ticks:
            return
        h.ewma = (
            tick_s if h.ewma is None
            else self._alpha * tick_s + (1.0 - self._alpha) * h.ewma
        )
        if h.baseline is None:
            h.baseline_obs.append(tick_s)
            if len(h.baseline_obs) >= self._baseline_ticks:
                h.baseline = min(h.baseline_obs)
                h.baseline_obs = []

    def health_score(self, replica: EngineReplica) -> Optional[float]:
        """EWMA / baseline, or None before the baseline is learned."""
        h = self._h(replica)
        if h.ewma is None or h.baseline is None or h.baseline <= 0:
            return None
        return h.ewma / h.baseline

    def reset_era(self, replica: EngineReplica) -> None:
        """Forget a replica's telemetry (after re-form: new engine, new
        compile warmup, new normal)."""
        self._health[replica.name] = _Health()

    def forget_replica(self, name: str) -> None:
        """Drop ALL per-replica state for a name that left the fleet
        for good (autoscaler removal / rolled-back add).  Names are
        never reused, so without this an always-on autoscaled fleet
        minting fresh names every diurnal cycle grows these dicts
        without bound."""
        self._health.pop(name, None)
        self._reform_attempts.pop(name, None)
        self._next_retry_at.pop(name, None)
        self.quarantined.pop(name, None)

    def _now(self, fleet) -> float:
        """The backoff clock: injected when the caller wants control
        (tests), the fleet's tick counter otherwise — both monotonic,
        both in 'ticks' units for the default config."""
        if self._clock is not None:
            return float(self._clock())
        return float(fleet.tick)

    def _retry_gated(self, fleet, replica: EngineReplica) -> bool:
        """True while the replica's backoff window is still open."""
        return self._now(fleet) < self._next_retry_at.get(
            replica.name, 0.0
        )

    # --- detection ----------------------------------------------------------
    def _diagnose(self, replica: EngineReplica) -> Optional[str]:
        if replica.crashed or (
                replica.missed_beats >= self.heartbeat_misses):
            return REASON_DEAD
        if not replica.slot_accounting_ok:
            return REASON_SLOT_LEAK
        h = self._h(replica)
        score = self.health_score(replica)
        if score is not None and score >= self._sick_threshold:
            h.streak += 1
            if h.streak >= self._k_checks:
                h.streak = 0
                return REASON_LATENCY
        else:
            h.streak = 0
        return None

    def poll(self, fleet) -> None:
        """One detection pass (every ``check_every`` fleet ticks),
        healing whatever it finds.  Called by ``ServingFleet.step``
        after the replicas have ticked, so this tick's evidence is in.
        Replicas left DEAD/EVICTED by an earlier failed re-form get a
        fresh attempt here while their budget lasts — a transient
        allocation failure must not strand a replica forever."""
        slo_burning = bool(self.slo_monitor is not None
                           and getattr(self.slo_monitor, "firing", ()))
        if fleet.tick % self.check_every != 0 and not slo_burning:
            return
        # snapshot the list: finishing a pending removal mutates
        # fleet.replicas mid-walk
        for replica in list(fleet.replicas):
            if replica.state == HEALTHY:
                reason = self._diagnose(replica)
                if reason is not None:
                    self.heal(fleet, replica, reason)
            elif replica.state == DRAINING:
                # finishing the requests that could not migrate; a crash
                # mid-drain escalates to the dead path, an empty engine
                # graduates to re-form — or, for a replica the
                # autoscaler is removing, to leaving the fleet
                if (replica.crashed or replica.missed_beats
                        >= self.heartbeat_misses):
                    if replica.pending_removal:
                        self.finish_removal(fleet, replica, dead=True)
                    else:
                        self.heal(fleet, replica, REASON_DEAD)
                elif not replica.engine.running_requests:
                    if replica.pending_removal:
                        self.finish_removal(fleet, replica, dead=False)
                    elif not self._retry_gated(fleet, replica):
                        self.retry_reform(fleet, replica)
            elif replica.state in (DEAD, EVICTED):
                if replica.pending_removal:
                    self.finish_removal(fleet, replica,
                                        dead=replica.state == DEAD)
                elif not self._retry_gated(fleet, replica):
                    self.retry_reform(fleet, replica)

    # --- recovery -----------------------------------------------------------
    def _record(self, kind: str, replica: EngineReplica, tick: int,
                **extra) -> None:
        self.events.append(
            dict(kind=kind, replica=replica.name, tick=tick, **extra)
        )

    def heal(self, fleet, replica: EngineReplica, reason: str) -> str:
        """Drain -> migrate -> re-form one replica; returns the outcome.

        Structural rollback guarantee: the survivors' state is only
        ever *added to* (migrated requests), and the replica's rebuild
        swaps its engine only after the builder (and its pre-flight)
        succeeded — so a failed re-form leaves the fleet exactly as the
        drain left it: serving on survivors, replica out of rotation.
        """
        tracer = get_tracer()
        self._arc_id += 1
        lane = None
        if tracer is not None:
            lane = tracer.lane("fleet", "supervisor")
            tracer.async_begin(
                "fleet_heal", lane, self._arc_id,
                {"replica": replica.name, "reason": reason,
                 "tick": fleet.tick},
            )
        self._record("detect", replica, fleet.tick, reason=reason,
                     score=self.health_score(replica))
        self._logger.info(
            f"FleetSupervisor: replica {replica.name} unhealthy "
            f"({reason}) at tick {fleet.tick}; draining"
        )

        dead = reason == REASON_DEAD
        if tracer is not None:
            with tracer.span("fleet.drain", lane,
                             {"replica": replica.name, "dead": dead}):
                migrated = fleet.drain_replica(replica, dead=dead)
        else:
            migrated = fleet.drain_replica(replica, dead=dead)
        stuck = 0 if dead else len(replica.engine.running_requests)
        if dead:
            replica.state = DEAD
        elif stuck:
            # alive is alive: requests whose resume prefix outgrew every
            # bucket cannot migrate, so the sick replica finishes them
            # out of rotation instead of the fleet failing them
            replica.state = DRAINING
        else:
            replica.state = EVICTED
        fleet.router.forget_replica(replica.name)
        self._record("drain", replica, fleet.tick, dead=dead,
                     migrated=len(migrated), stuck=stuck)

        if tracer is not None:
            with tracer.span("fleet.migrate", lane,
                             {"replica": replica.name,
                              "requests": len(migrated)}):
                placed, parked = fleet.redispatch(migrated)
        else:
            placed, parked = fleet.redispatch(migrated)
        self._record("migrate", replica, fleet.tick, placed=placed,
                     parked=parked)

        if replica.state == DRAINING:
            # re-forming now would discard the engine the stuck
            # requests are still decoding on; poll() re-forms once the
            # drain completes (its own fleet_heal arc)
            if tracer is not None:
                tracer.async_end("fleet_heal", lane, self._arc_id,
                                 {"outcome": "draining", "stuck": stuck})
            return "draining"
        outcome, detail = self._attempt_reform(fleet, replica, tracer,
                                               lane)
        if tracer is not None:
            tracer.async_end("fleet_heal", lane, self._arc_id,
                             dict({"outcome": outcome}, **detail))
        return outcome

    def finish_removal(self, fleet, replica: EngineReplica,
                       *, dead: bool) -> None:
        """Complete an autoscaler scale-down whose drain has finished
        (or whose replica died mid-drain: its ledger requests are
        recovered first — a removal must lose exactly as many tokens
        as a heal, zero).  The replica leaves the fleet for good."""
        tracer = get_tracer()
        lane = (tracer.lane("fleet", "autoscaler")
                if tracer is not None else None)
        if dead:
            if tracer is not None:
                with tracer.span("fleet.drain", lane,
                                 {"replica": replica.name,
                                  "dead": True, "removal": True}):
                    migrated = fleet.drain_replica(replica, dead=True)
            else:
                migrated = fleet.drain_replica(replica, dead=True)
            fleet.redispatch(migrated)
        fleet.finalize_removal(replica)
        self._record("removed", replica, fleet.tick, dead=dead)
        self._logger.info(
            f"FleetSupervisor: replica {replica.name} removed "
            f"(scale-down{' after mid-drain death' if dead else ''})"
        )
        if tracer is not None:
            tracer.instant(
                "scale_down_complete", lane,
                {"replica": replica.name, "dead": dead},
            )

    def retry_reform(self, fleet, replica: EngineReplica) -> str:
        """A fresh re-form attempt for a replica stranded by an earlier
        failure — its own ``fleet_heal`` arc (reason ``reform_retry``),
        same budget."""
        tracer = get_tracer()
        self._arc_id += 1
        lane = None
        if tracer is not None:
            lane = tracer.lane("fleet", "supervisor")
            tracer.async_begin(
                "fleet_heal", lane, self._arc_id,
                {"replica": replica.name, "reason": "reform_retry",
                 "tick": fleet.tick},
            )
        outcome, detail = self._attempt_reform(fleet, replica, tracer,
                                               lane)
        if tracer is not None:
            tracer.async_end("fleet_heal", lane, self._arc_id,
                             dict({"outcome": outcome}, **detail))
        return outcome

    def _quarantine(self, fleet, replica: EngineReplica,
                    attempts: int) -> None:
        """Retire a replica whose re-form budget is exhausted and
        ledger it: quarantined replicas stay in ``fleet.replicas``
        (visible capacity loss) but are permanently out of rotation,
        and the ledger entry says when and why."""
        replica.state = RETIRED
        self._next_retry_at.pop(replica.name, None)
        self.quarantined[replica.name] = dict(
            tick=fleet.tick, attempts=int(attempts),
            reason="reform_budget_exhausted",
        )
        self._record("retired", replica, fleet.tick,
                     attempts=int(attempts))

    def _attempt_reform(self, fleet, replica: EngineReplica, tracer,
                        lane) -> tuple:
        """One budgeted rebuild; (outcome, trace-arg detail)."""
        attempts = self._reform_attempts.get(replica.name, 0)
        if attempts >= self.max_reforms:
            self._quarantine(fleet, replica, attempts)
            return RETIRED_OUT, {}
        self._reform_attempts[replica.name] = attempts + 1
        try:
            if tracer is not None:
                with tracer.span("fleet.reform", lane,
                                 {"replica": replica.name,
                                  "attempt": attempts + 1}):
                    replica.rebuild()
            else:
                replica.rebuild()
        except Exception as exc:
            # the verifier (or the slab allocation) rejected the
            # re-form: the rollback is structural — nothing was mutated
            # — and the budget decides whether the replica retires now
            fleet.stats.reform_failures += 1
            failures = self._reform_attempts[replica.name]
            retired = failures >= self.max_reforms
            backoff = 0.0
            if retired:
                self._quarantine(fleet, replica, failures)
            elif self.reform_backoff_base > 0:
                # exponential: base, 2*base, 4*base ... capped — the
                # NEXT standalone retry waits this long (heal()'s
                # inline attempt on fresh detection is never gated)
                backoff = float(min(
                    self.reform_backoff_cap,
                    self.reform_backoff_base * 2 ** (failures - 1),
                ))
                self._next_retry_at[replica.name] = (
                    self._now(fleet) + backoff
                )
            self._record(REFORM_FAILED, replica, fleet.tick,
                         error=str(exc), retired=retired,
                         backoff=backoff)
            self._logger.warning(
                f"FleetSupervisor: re-form of {replica.name} rejected "
                f"({exc}); serving on survivors"
                + (" — replica retired" if retired else "")
            )
            return REFORM_FAILED, {"error": str(exc)}
        # a SUCCESSFUL re-form refunds the budget: max_reforms bounds
        # consecutive failures, not lifetime faults — a long-lived fleet
        # must not monotonically retire replicas it keeps proving it
        # can heal
        self._reform_attempts[replica.name] = 0
        self._next_retry_at.pop(replica.name, None)
        self.reset_era(replica)
        fleet.stats.reforms += 1
        self._record(REFORMED, replica, fleet.tick,
                     generation=replica.generation)
        self._logger.info(
            f"FleetSupervisor: replica {replica.name} re-formed "
            f"(generation {replica.generation})"
        )
        return REFORMED, {"generation": replica.generation}


__all__ = [
    "FleetSupervisor",
    "REASON_DEAD",
    "REASON_LATENCY",
    "REASON_SLOT_LEAK",
    "REFORMED",
    "REFORM_FAILED",
]
