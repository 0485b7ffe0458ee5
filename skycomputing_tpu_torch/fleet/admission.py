"""Fleet admission control: bounded intake with explicit load-shedding (the port's own
copy of ``skycomputing_tpu/fleet/admission.py``).

PURE STDLIB BY CONTRACT, like :mod:`.router` — decision logic over
scalar fleet state, loadable by file path for the CI smoke on a bare
runner.

The philosophy is vLLM's exhaustion-as-queueing extended one level up:
a single engine turns slot exhaustion into queueing; the fleet turns
queue exhaustion into *visible rejection*.  Under a spike the failure
mode to prevent is the unbounded queue — every accepted request makes
every other request slower, TPOT for *everyone* collapses, and the host
eventually OOMs on queued prompts.  Shedding keeps the accepted
population's SLOs intact and tells the rejected population exactly when
to come back (a ``Retry-After``-style hint), which is strictly more
information than timing out.

Three gates, in order:

1. **pending bound** — total queued work across the fleet above
   ``max_pending`` (default: ``queue_factor ×`` live slot capacity)
   rejects with ``queue_full``.
2. **priority shed band** — above ``shed_fraction × max_pending``,
   ``batch``-class requests shed (``shed_low_priority``) while
   ``interactive`` requests still admit; a spike degrades background
   work first.
3. **deadline feasibility** — a request whose caller gave it
   ``deadline_s`` is rejected up front (``deadline_unmeetable``) when
   the estimated queue wait already exceeds it: admitting work that
   cannot possibly meet its deadline only steals capacity from work
   that can.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# priority classes, lowest number = most important
INTERACTIVE = "interactive"
BATCH = "batch"
_PRIORITY_RANK = {INTERACTIVE: 0, BATCH: 1}

# rejection reasons (stable ids, counted per-reason in FleetStats)
QUEUE_FULL = "queue_full"
SHED_LOW_PRIORITY = "shed_low_priority"
DEADLINE_UNMEETABLE = "deadline_unmeetable"
NO_HEALTHY_REPLICA = "no_healthy_replica"
REPLICAS_SATURATED = "replicas_saturated"
ADMISSION_BLIP = "admission_blip"


@dataclass
class AdmitDecision:
    """The outcome of one admission decision.

    ``admitted`` False carries a ``reason`` and a ``retry_after_s``
    backpressure hint (the Retry-After header of this stack); True
    carries the ``replica`` name once the fleet has dispatched."""

    admitted: bool
    reason: Optional[str] = None
    retry_after_s: Optional[float] = None
    replica: Optional[str] = None
    detail: Dict[str, Any] = field(default_factory=dict)


class AdmissionController:
    """Bounded, priority- and deadline-aware fleet admission."""

    def __init__(
        self,
        max_pending: Optional[int] = None,
        queue_factor: float = 4.0,
        shed_fraction: float = 0.75,
        service_s_estimate: float = 0.05,
        slo_monitor=None,
        slo_tighten: float = 0.5,
    ):
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}"
            )
        if not 0.0 < shed_fraction <= 1.0:
            raise ValueError(
                f"shed_fraction must be in (0, 1], got {shed_fraction}"
            )
        if not 0.0 < slo_tighten <= 1.0:
            raise ValueError(
                f"slo_tighten must be in (0, 1], got {slo_tighten}"
            )
        self.max_pending = max_pending
        self.queue_factor = float(queue_factor)
        self.shed_fraction = float(shed_fraction)
        self.service_s_estimate = float(service_s_estimate)
        # the slot capacity an explicit max_pending was SIZED FOR.  The
        # fleet stamps its construction-time capacity here, and
        # pending_bound() re-scales the explicit bound by live/baseline
        # — so when the autoscaler adds replicas the bound loosens with
        # them (capacity the admission gate never uses is capacity
        # wasted), and when replicas die it tightens, which is exactly
        # when admission must tighten.  None (the default, and every
        # directly-constructed controller) keeps the explicit bound
        # fixed, the historical behavior.
        self.baseline_capacity: Optional[int] = None
        # optional online-SLO signal (telemetry.slo.SloMonitor, but
        # DUCK-TYPED — this module stays pure stdlib / file-path
        # loadable): while any declared SLO burns, the pending bound
        # tightens by slo_tighten, shedding load before the burn
        # exhausts the error budget.  The decision stays pure: the
        # monitor only moves the bound, visibly (detail carries it).
        self.slo_monitor = slo_monitor
        self.slo_tighten = float(slo_tighten)
        # the sanctioned chaos hook (the chaos plane's admission_blip
        # kind): while set, every decision rejects with the
        # ADMISSION_BLIP reason — a transient front-door outage that
        # stays VISIBLE (reasoned verdict + per-reason counter), never
        # a silent drop.  The injector owns setting/clearing it at
        # exact ticks; the decision itself stays pure.
        self.blip_active = False

    # --- sizing -------------------------------------------------------------
    def _slo_burning(self) -> bool:
        return bool(self.slo_monitor is not None
                    and getattr(self.slo_monitor, "firing", ()))

    def pending_bound(self, capacity_slots: int) -> int:
        """The effective pending bound for the current LIVE capacity.

        An explicit ``max_pending`` wins — re-scaled by
        ``capacity_slots / baseline_capacity`` when the fleet stamped
        the baseline it was sized for, so the bound tracks healthy-
        replica capacity as the fleet scales (or loses replicas)
        instead of freezing at its construction-time value.  Otherwise
        ``queue_factor ×`` the healthy fleet's slot capacity — which
        shrinks when replicas die, exactly when admission must tighten.
        A firing SLO monitor tightens either form by ``slo_tighten``."""
        if self.max_pending is not None:
            bound = self.max_pending
            base = self.baseline_capacity
            if base and base > 0 and capacity_slots >= 0 \
                    and capacity_slots != base:
                bound = max(1, int(round(
                    bound * capacity_slots / base
                )))
        else:
            bound = max(1, int(self.queue_factor * max(capacity_slots, 0)))
        if self._slo_burning():
            bound = max(1, int(bound * self.slo_tighten))
        return bound

    def _service_s(self, tpot_p50_s: Optional[float]) -> float:
        """Per-queue-position wait estimate: observed decode pace when
        the fleet has one, the configured prior until then."""
        if tpot_p50_s is not None and tpot_p50_s > 0:
            return float(tpot_p50_s)
        return self.service_s_estimate

    def estimate_wait_s(self, pending: int, capacity_slots: int,
                        tpot_p50_s: Optional[float] = None) -> float:
        """Rough queue-wait estimate: pending requests drain
        ``capacity_slots`` at a time, one service quantum each."""
        lanes = max(capacity_slots, 1)
        quantum = self._service_s(tpot_p50_s)
        return (pending / lanes) * quantum

    # --- the decision -------------------------------------------------------
    def decide(
        self,
        *,
        pending: int,
        capacity_slots: int,
        priority: str = BATCH,
        deadline_s: Optional[float] = None,
        tpot_p50_s: Optional[float] = None,
    ) -> AdmitDecision:
        """One admission decision from live fleet state.

        ``pending`` is total queued-but-unserved work across the fleet
        (replica queues + migration limbo); ``capacity_slots`` the
        healthy replicas' total KV slots.  Pure and side-effect-free:
        the fleet owns counting the outcome.
        """
        if priority not in _PRIORITY_RANK:
            raise ValueError(
                f"unknown priority {priority!r}; known: "
                f"{sorted(_PRIORITY_RANK)}"
            )
        if self.blip_active:
            # the injected front-door outage gates FIRST: a blip means
            # the intake itself is down, so no other evidence matters —
            # callers get the standard Retry-After-style hint
            return AdmitDecision(
                False, reason=ADMISSION_BLIP,
                retry_after_s=self._service_s(tpot_p50_s) * 5.0,
                detail=dict(pending=pending),
            )
        if capacity_slots <= 0:
            return AdmitDecision(
                False, reason=NO_HEALTHY_REPLICA,
                retry_after_s=self._service_s(tpot_p50_s) * 10.0,
                detail=dict(pending=pending),
            )
        bound = self.pending_bound(capacity_slots)
        wait_s = self.estimate_wait_s(pending, capacity_slots, tpot_p50_s)
        # the hint callers get on any reject: how long until the
        # overflow ahead of them should have drained
        over = max(pending - bound + 1, 1)
        retry_after_s = self.estimate_wait_s(
            over, capacity_slots, tpot_p50_s
        )
        slo_tightened = self._slo_burning()
        if pending >= bound:
            return AdmitDecision(
                False, reason=QUEUE_FULL, retry_after_s=retry_after_s,
                detail=dict(pending=pending, bound=bound,
                            slo_tightened=slo_tightened),
            )
        if (priority != INTERACTIVE
                and pending >= self.shed_fraction * bound):
            return AdmitDecision(
                False, reason=SHED_LOW_PRIORITY,
                retry_after_s=retry_after_s,
                detail=dict(pending=pending, bound=bound,
                            priority=priority),
            )
        if deadline_s is not None and wait_s > deadline_s:
            return AdmitDecision(
                False, reason=DEADLINE_UNMEETABLE,
                retry_after_s=max(retry_after_s, wait_s - deadline_s),
                detail=dict(estimated_wait_s=wait_s,
                            deadline_s=deadline_s),
            )
        return AdmitDecision(True, detail=dict(pending=pending,
                                               bound=bound))


__all__ = [
    "ADMISSION_BLIP",
    "AdmissionController",
    "AdmitDecision",
    "BATCH",
    "DEADLINE_UNMEETABLE",
    "INTERACTIVE",
    "NO_HEALTHY_REPLICA",
    "QUEUE_FULL",
    "REPLICAS_SATURATED",
    "SHED_LOW_PRIORITY",
]
