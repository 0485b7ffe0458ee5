"""FleetAutoscaler: close the SLO loop at replica granularity (the port's own
copy of ``skycomputing_tpu/fleet/autoscaler.py``).

Before this module the control loop had a hole: the SLO monitor emits
multi-window burn rates, admission tightens under them, the supervisor
heals what breaks — but the replica count was fixed at construction.
Sustained burn could only shed traffic; sustained slack never released
a chip.  The autoscaler converts both signals into VERIFIED replica
mutations:

- **sustained burn -> ADD**: when the monitor's ``firing_streak`` (both
  burn windows >= 1.0, for N consecutive ticks — one blip is not a
  trend) clears ``up_streak``, the autoscaler proposes one replica.
  The proposal passes a ``plan_check.verify_scale_payload`` pre-flight
  (chip budget, ``max_replicas``) BEFORE any mutation; a feasible add
  then builds through the supervisor's budgeted verify-then-apply
  re-form machinery (``ServingFleet.add_replica`` parks a provisional
  replica and ``_attempt_reform`` runs the same verified builder a
  post-crash re-form runs).  A rejected add leaves the fleet exactly
  as it was, counted in ``scale_rejected``.
- **sustained slack -> drain-then-REMOVE**: when no target fires and
  fleet utilization stays under ``slack_utilization`` for
  ``down_streak`` consecutive ticks, the least-loaded healthy replica
  drains gracefully (the same preempt contract a sick-replica heal
  uses, token streams intact) and leaves the fleet; requests that
  cannot migrate finish on the replica first (DRAINING +
  ``pending_removal`` — the supervisor finalizes, never re-forms).

**Hysteresis + cooldown**: ``up_streak`` < ``down_streak`` by default
(adding capacity under burn is urgent, releasing it is not), and every
decision — including a rejection — starts a ``cooldown_ticks`` window
in which no further decision fires, so one noisy window can never flap
the fleet.  Every decision lands in :attr:`events`, in trace instants
on the ``("fleet", "autoscaler")`` lane, and in the counter-disciplined
``FleetStats`` fields (``scale_ups`` / ``scale_downs`` /
``scale_rejected``).

The autoscaler never touches an engine: it reads fleet-level evidence
and calls the two fleet verbs.  ``plan_check`` is imported lazily at
decision time (the repo-wide idiom for analysis-layer verifiers).

**Per-pool mode** (disaggregated fleets): construct with ``pools``
mapping each replica role to its own ``min_replicas`` /
``max_replicas`` bounds and the SLO ``signals`` that attribute burn to
it.  Sustained burn then scales the pool whose signals match the firing
targets — TTFT burn grows the prefill pool, TPOT/queue-depth burn grows
the decode pool — and sustained slack drains the pool furthest above
its floor.  Every decision payload carries the ``pool`` it targets, so
``verify_scale_payload`` pre-flights the per-pool bounds and the chip
budget before any mutation, exactly as in the monolithic mode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..telemetry import get_tracer
from ..utils import Logger
from .replica import HEALTHY, RETIRED

# decision kinds (stable ids in events and trace args)
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
SCALE_REJECTED = "scale_rejected"

#: default burn-attribution signals per well-known pool role: a firing
#: SLO target whose name or metric contains one of these substrings
#: charges its burn to that pool.  TTFT is prefill work by definition;
#: TPOT and queue depth are decode-side pressure (slots and pace).
POOL_SIGNALS = {
    "prefill": ("ttft",),
    "decode": ("tpot", "queue"),
}


class FleetAutoscaler:
    """Burn/slack -> verified replica add/remove, with hysteresis."""

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: Optional[int] = None,
        chip_budget: Optional[int] = None,
        replica_chips: int = 1,
        up_streak: int = 3,
        down_streak: int = 24,
        cooldown_ticks: int = 32,
        slack_utilization: float = 0.3,
        pools: Optional[Dict[str, Dict[str, Any]]] = None,
        logger: Optional[Logger] = None,
    ):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}"
            )
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= "
                f"min_replicas ({min_replicas})"
            )
        if up_streak < 1 or down_streak < 1:
            raise ValueError(
                "up_streak and down_streak must be >= 1"
            )
        if cooldown_ticks < 0:
            raise ValueError(
                f"cooldown_ticks must be >= 0, got {cooldown_ticks}"
            )
        if replica_chips < 1:
            raise ValueError(
                f"replica_chips must be >= 1, got {replica_chips}"
            )
        if not 0.0 <= float(slack_utilization) < 1.0:
            raise ValueError(
                f"slack_utilization must be in [0, 1), got "
                f"{slack_utilization}"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = (None if max_replicas is None
                             else int(max_replicas))
        #: chips the fleet may hold in total; None = the fleet's own
        #: device pool (``ServingFleet.chip_capacity``)
        self.chip_budget = (None if chip_budget is None
                            else int(chip_budget))
        self.replica_chips = int(replica_chips)
        self.up_streak = int(up_streak)
        self.down_streak = int(down_streak)
        self.cooldown_ticks = int(cooldown_ticks)
        self.slack_utilization = float(slack_utilization)
        #: per-role pool config (disaggregated fleets): role ->
        #: dict(min_replicas, max_replicas, signals).  Empty dict =
        #: monolithic mode, every decision fleet-wide.
        self.pools: Dict[str, Dict[str, Any]] = {}
        for pool, cfg in (pools or {}).items():
            if not isinstance(pool, str) or not pool:
                raise ValueError(
                    f"pool role must be a non-empty string, got {pool!r}"
                )
            if not isinstance(cfg, dict):
                raise ValueError(
                    f"pool {pool!r} config must be a dict, got "
                    f"{type(cfg).__name__}"
                )
            lo = int(cfg.get("min_replicas", 1))
            hi = cfg.get("max_replicas")
            hi = None if hi is None else int(hi)
            if lo < 1:
                raise ValueError(
                    f"pool {pool!r} min_replicas must be >= 1, got {lo}"
                )
            if hi is not None and hi < lo:
                raise ValueError(
                    f"pool {pool!r} max_replicas ({hi}) must be >= "
                    f"min_replicas ({lo})"
                )
            signals = tuple(
                str(s).lower()
                for s in (cfg.get("signals")
                          or POOL_SIGNALS.get(pool)
                          or (pool,))
            )
            self.pools[pool] = dict(min_replicas=lo, max_replicas=hi,
                                    signals=signals)
        self._logger = logger or Logger()
        self._slack_streak = 0
        self._cooldown_until = 0
        self._arc_id = 0
        #: every decision, in order: kind, tick, detail — the
        #: supervisor-events idiom for the scale plane
        self.events: List[Dict[str, Any]] = []

    # --- evidence -----------------------------------------------------------
    @staticmethod
    def _live_replicas(fleet) -> List[Any]:
        """Replicas that hold (or will hold) chips: everything not
        retired and not already on its way out."""
        return [r for r in fleet.replicas
                if r.state != RETIRED and not r.pending_removal]

    @staticmethod
    def utilization(fleet) -> float:
        """Busy work (running + queued + limbo) over live slot
        capacity; >= 1.0 means the fleet cannot even hold its backlog
        concurrently."""
        capacity = fleet._capacity_slots()
        if capacity <= 0:
            return 1.0
        busy = len(fleet._limbo)
        for r in fleet.healthy_replicas:
            busy += len(r.engine.running_requests)
            busy += r.engine.stats.queue_depth
        return busy / capacity

    def burn_streak(self, fleet) -> int:
        """Consecutive fleet ticks with >= 1 SLO target firing on BOTH
        burn windows (the monitor's ``firing_streak`` surface); 0 with
        no monitor attached — an autoscaler cannot read burn that is
        not being measured."""
        return int(getattr(fleet.slo, "firing_streak", 0) or 0)

    def _pool_live(self, fleet, pool: str) -> List[Any]:
        """Live replicas carrying ``pool``'s role."""
        return [r for r in self._live_replicas(fleet)
                if getattr(r, "role", "") == pool]

    def _burn_pool(self, fleet) -> Optional[str]:
        """The pool the current SLO burn charges to (per-pool mode).

        Matches every firing target's name AND metric against each
        pool's signal substrings, in pool declaration order.  Burn no
        signal claims falls to the LAST declared pool — unattributed
        pressure still grows capacity somewhere, and decode (declared
        last by :class:`~..disagg.pools.DisaggFleet`) is the
        general-purpose sink."""
        if not self.pools:
            return None
        firing = tuple(getattr(fleet.slo, "firing", ()) or ())
        metrics = {
            str(t.name): str(getattr(t, "metric", ""))
            for t in (getattr(fleet.slo, "targets", ()) or ())
        }
        for pool, cfg in self.pools.items():
            for name in firing:
                hay = f"{name} {metrics.get(str(name), '')}".lower()
                if any(sig in hay for sig in cfg["signals"]):
                    return pool
        return next(reversed(self.pools))

    def _slack_pool(self, fleet) -> Optional[str]:
        """The pool with the most removable slack: live count above its
        own floor, >= 2 healthy members (never drain a pool to an
        unserved role mid-heal).  None when no pool can shrink."""
        best, best_slack = None, 0
        for pool, cfg in self.pools.items():
            live = self._pool_live(fleet, pool)
            healthy = [r for r in live if r.state == HEALTHY]
            slack = len(live) - cfg["min_replicas"]
            if slack > best_slack and len(healthy) >= 2:
                best, best_slack = pool, slack
        return best

    def _payload(self, fleet, action: str, live: int,
                 pool: Optional[str] = None) -> Dict[str, Any]:
        budget = (self.chip_budget if self.chip_budget is not None
                  else fleet.chip_capacity())
        cfg = self.pools.get(pool) if pool is not None else None
        payload = dict(
            action=action,
            replicas=live,
            delta=1,
            min_replicas=(cfg["min_replicas"] if cfg
                          else self.min_replicas),
            max_replicas=(cfg["max_replicas"] if cfg
                          else self.max_replicas),
            chips_required=self.replica_chips,
            chips_free=max(budget - fleet.chips_in_use(), 0),
        )
        if pool is not None:
            payload["pool"] = pool
        return payload

    # --- the decision loop --------------------------------------------------
    def _record(self, kind: str, tick: int, **extra) -> None:
        self.events.append(dict(kind=kind, tick=tick, **extra))

    def _reject(self, fleet, payload: Dict[str, Any],
                problems: List[str], tracer) -> None:
        fleet.stats.scale_rejected += 1
        self._record(SCALE_REJECTED, fleet.tick, payload=payload,
                     problems=problems)
        self._cooldown_until = fleet.tick + self.cooldown_ticks
        self._logger.warning(
            f"FleetAutoscaler: {payload['action']} rejected at tick "
            f"{fleet.tick}: {'; '.join(problems)}"
        )
        if tracer is not None:
            tracer.instant(
                SCALE_REJECTED, tracer.lane("fleet", "autoscaler"),
                {"action": payload["action"], "problems": problems},
            )

    def poll(self, fleet) -> Optional[str]:
        """One decision pass; called by ``ServingFleet.step`` after the
        SLO monitor evaluated this tick.  Returns the decision kind it
        acted on (or None)."""
        live = self._live_replicas(fleet)
        burn = self.burn_streak(fleet)
        firing = bool(getattr(fleet.slo, "firing", ()) or ())
        if not firing and self.utilization(fleet) \
                <= self.slack_utilization:
            self._slack_streak += 1
        else:
            self._slack_streak = 0
        if fleet.tick < self._cooldown_until:
            return None
        if any(r.pending_removal for r in fleet.replicas):
            # a drain is still in flight; one mutation at a time
            return None
        if burn >= self.up_streak:
            pool = self._burn_pool(fleet)
            count = (len(self._pool_live(fleet, pool))
                     if pool is not None else len(live))
            return self._try_scale_up(fleet, count, pool=pool)
        if self._slack_streak >= self.down_streak:
            if self.pools:
                pool = self._slack_pool(fleet)
                if pool is None:
                    return None
                return self._try_scale_down(
                    fleet, self._pool_live(fleet, pool), pool=pool)
            healthy = [r for r in live if r.state == HEALTHY]
            if (len(live) > self.min_replicas
                    # a sick/dead replica mid-heal is not removable
                    # slack: with < 2 healthy replicas the victim
                    # would be the last one serving
                    and len(healthy) >= 2):
                return self._try_scale_down(fleet, live)
        return None

    # --- execution ----------------------------------------------------------
    def _role_spec(self, fleet, pool: Optional[str]
                   ) -> Optional[Dict[str, Any]]:
        """The replica spec a per-pool add builds with: the fleet's
        own ``role_spec`` (pool kwargs + device placement) when it has
        one, a bare role tag otherwise.  None in monolithic mode —
        ``add_replica`` then picks its own default spec."""
        if pool is None:
            return None
        role_spec = getattr(fleet, "role_spec", None)
        if callable(role_spec):
            return role_spec(pool)
        return dict(role=pool)

    def _try_scale_up(self, fleet, live: int,
                      pool: Optional[str] = None) -> Optional[str]:
        from ..analysis.plan_check import verify_scale_payload

        tracer = get_tracer()
        payload = self._payload(fleet, "add", live, pool=pool)
        problems = verify_scale_payload(payload)
        if problems:
            self._reject(fleet, payload, problems, tracer)
            return SCALE_REJECTED
        spec = self._role_spec(fleet, pool)
        self._arc_id += 1
        lane = None
        if tracer is not None:
            lane = tracer.lane("fleet", "autoscaler")
            tracer.async_begin(
                "fleet_scale", lane, self._arc_id,
                {"action": "add", "tick": fleet.tick,
                 "replicas": live, "pool": pool or "",
                 "burn_streak": self.burn_streak(fleet)},
            )
        try:
            if tracer is not None:
                with tracer.span("fleet.scale_up", lane,
                                 {"replicas": live}):
                    replica = fleet.add_replica(spec)
            else:
                replica = fleet.add_replica(spec)
        except Exception as exc:
            # the verified build said no (slab allocation, serving
            # pre-flight): structural rollback already happened inside
            # add_replica — count it and back off
            self._reject(fleet, payload, [str(exc)], tracer)
            if tracer is not None:
                tracer.async_end("fleet_scale", lane, self._arc_id,
                                 {"outcome": SCALE_REJECTED,
                                  "error": str(exc)})
            return SCALE_REJECTED
        fleet.stats.scale_ups += 1
        self._record(SCALE_UP, fleet.tick, replica=replica.name,
                     replicas=live + 1, pool=pool or "")
        self._cooldown_until = fleet.tick + self.cooldown_ticks
        self._slack_streak = 0
        self._logger.info(
            f"FleetAutoscaler: scaled up to {live + 1} replicas "
            f"(+{replica.name}) at tick {fleet.tick}"
        )
        if tracer is not None:
            tracer.async_end("fleet_scale", lane, self._arc_id,
                             {"outcome": SCALE_UP,
                              "replica": replica.name})
        return SCALE_UP

    def _pick_victim(self, live: List[Any],
                     pool: Optional[str] = None) -> Optional[Any]:
        """Least-loaded HEALTHY replica (cheapest drain); newest wins
        ties so long-lived replicas keep their warmed caches.  With a
        pool, only that role's members are candidates."""
        healthy = [r for r in live if r.state == HEALTHY
                   and (pool is None
                        or getattr(r, "role", "") == pool)]
        if not healthy:
            return None
        return min(
            reversed(healthy),
            key=lambda r: (len(r.engine.running_requests)
                           + r.engine.stats.queue_depth),
        )

    def _try_scale_down(self, fleet, live: List[Any],
                        pool: Optional[str] = None) -> Optional[str]:
        from ..analysis.plan_check import verify_scale_payload

        tracer = get_tracer()
        payload = self._payload(fleet, "remove", len(live), pool=pool)
        problems = verify_scale_payload(payload)
        if problems:
            self._reject(fleet, payload, problems, tracer)
            return SCALE_REJECTED
        victim = self._pick_victim(live, pool=pool)
        if victim is None:
            return None
        self._arc_id += 1
        lane = None
        if tracer is not None:
            lane = tracer.lane("fleet", "autoscaler")
            tracer.async_begin(
                "fleet_scale", lane, self._arc_id,
                {"action": "remove", "tick": fleet.tick,
                 "replica": victim.name,
                 "slack_streak": self._slack_streak},
            )
        try:
            if tracer is not None:
                with tracer.span("fleet.scale_down", lane,
                                 {"replica": victim.name}):
                    outcome = fleet.remove_replica(victim.name)
            else:
                outcome = fleet.remove_replica(victim.name)
        except ValueError as exc:
            # the fleet's own guard said no (e.g. the victim became the
            # last healthy replica between the pick and the drain): a
            # rejected decision, never a crashed serving loop
            self._reject(fleet, payload, [str(exc)], tracer)
            if tracer is not None:
                tracer.async_end("fleet_scale", lane, self._arc_id,
                                 {"outcome": SCALE_REJECTED,
                                  "error": str(exc)})
            return SCALE_REJECTED
        fleet.stats.scale_downs += 1
        self._record(SCALE_DOWN, fleet.tick, replica=victim.name,
                     replicas=len(live) - 1, drain=outcome,
                     pool=pool or "")
        self._cooldown_until = fleet.tick + self.cooldown_ticks
        self._slack_streak = 0
        self._logger.info(
            f"FleetAutoscaler: scaling down to {len(live) - 1} "
            f"replicas (-{victim.name}, {outcome}) at tick {fleet.tick}"
        )
        if tracer is not None:
            tracer.async_end("fleet_scale", lane, self._arc_id,
                             {"outcome": SCALE_DOWN,
                              "replica": victim.name,
                              "drain": outcome})
        return SCALE_DOWN


__all__ = [
    "FleetAutoscaler",
    "POOL_SIGNALS",
    "SCALE_DOWN",
    "SCALE_REJECTED",
    "SCALE_UP",
]
