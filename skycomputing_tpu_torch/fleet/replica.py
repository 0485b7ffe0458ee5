"""One fleet member: a ServingEngine plus health state and a rebuild path
(the port of ``skycomputing_tpu/fleet/replica.py``).

The replica is the unit of failure AND of recovery: it owns the
zero-arg ``build_engine`` callable that produced its engine (the
worker-manager-path constructor, with its serving pre-flight), so
re-forming after a crash is *the same verified construction* the fleet
booted with — verify-then-apply by reuse, not by re-implementation.
Fault injection lands here too (:meth:`crash` / :meth:`inject_stall` /
:meth:`leak_slots`, driven by
:class:`~..dynamics.faults.FleetFaultInjector`), so a chaos plan and the
supervisor see one consistent surface.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..serving.engine import ServingEngine, ServingStats

# replica lifecycle states
HEALTHY = "healthy"    # serving traffic
DRAINING = "draining"  # sick, out of rotation, finishing requests that
#                        cannot migrate (resume prefix outgrew every
#                        bucket) before re-forming — alive is alive
DEAD = "dead"          # crashed/declared dead, awaiting re-form
EVICTED = "evicted"    # drained (sick), awaiting re-form
RETIRED = "retired"    # re-form budget exhausted; permanently out


class ReplicaCrashed(RuntimeError):
    """A tick reached a crashed replica's engine (the in-process stand-in
    for an RPC timeout against a dead server)."""


class EngineReplica:
    """A named :class:`ServingEngine` with health and fault surface."""

    #: metric classification for :meth:`stats_snapshot`, this class's
    #: registered fleet source: the engine's own surface plus the
    #: replica-level ``generation`` (a version stamp, not a rate-able
    #: counter — it only moves at re-forms and resets with the replica
    #: object, so deriving a per-second rate from it is meaningless).
    FIELD_TYPES = {**ServingStats.FIELD_TYPES, "generation": "gauge"}

    def __init__(self, name: str,
                 build_engine: Callable[[], ServingEngine],
                 *, defer_build: bool = False, role: str = ""):
        self.name = str(name)
        self._build = build_engine
        # pool role for disaggregated serving ("prefill" / "decode";
        # empty = the monolithic default, routable for any work).  A
        # label, not behavior: the engine spec behind build_engine is
        # what actually specializes the replica — the role just makes
        # that specialization visible to the router and autoscaler.
        self.role = str(role)
        if defer_build:
            # a PROVISIONAL replica (fleet scale-up): no engine yet,
            # parked DEAD so the only way it can ever serve is through
            # the supervisor's budgeted verify-then-apply re-form path
            # (_attempt_reform -> rebuild) — an autoscaler ADD is the
            # same verified construction as a post-crash re-form, by
            # reuse.  generation -1 so the first successful build lands
            # at 0, exactly like an eagerly-built replica.
            self.engine: Optional[ServingEngine] = None
            self.state = DEAD
            self.generation = -1
        else:
            self.engine = build_engine()
            # request-scoped trace spans attribute their segments to
            # the replica, not the anonymous "engine"
            self.engine.trace_name = self.name
            self.state = HEALTHY
            self.generation = 0
        # set by the autoscaler's drain-then-remove: a DRAINING replica
        # flagged here is finishing its last requests on the way OUT of
        # the fleet — the supervisor must finalize the removal when the
        # drain empties, never re-form it
        self.pending_removal = False
        # monotonic counter discipline across re-forms: a rebuilt
        # engine starts a fresh ServingStats, but the REPLICA's
        # counters must never go backwards mid-run or every
        # time-series rate over the fleet registry turns undefined at
        # each heal.  Prior generations' cumulative counters accumulate
        # here; stats_snapshot() adds them back.
        self._carried: Dict[str, float] = {}
        # fault surface (written by FleetFaultInjector and the chaos
        # plane's FaultInjector)
        self.crashed = False
        self._stall_s = 0.0
        self._stall_clear_tick: Optional[int] = None
        self.leaked_slots: List[int] = []
        self._pending_leaks = 0
        self._build_failures = 0
        # heartbeat ledger: beats are successful ticks; the supervisor
        # reads (and resets) consecutive misses
        self.beats = 0
        self.missed_beats = 0

    # --- serving ------------------------------------------------------------
    def tick(self, fleet_tick: int) -> None:
        """One engine iteration, or :class:`ReplicaCrashed`.

        Named ``tick`` (not ``step``) deliberately: the engine's
        ``step()`` ends in the device-to-host copy of its tokens, so the
        fleet timing a ``tick()`` call measures real compute, and the
        name keeps that distinction visible at the call site."""
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.name} is crashed")
        if (self._stall_clear_tick is not None
                and fleet_tick >= self._stall_clear_tick):
            self._stall_s = 0.0
            self._stall_clear_tick = None
        if self._pending_leaks > 0:
            # a leak is sticky: it seizes capacity as it frees, the way
            # a real free-list bug eats a pool one release at a time
            self._pending_leaks -= self._leak_now(self._pending_leaks)
        self.engine.step()
        if self._stall_s > 0.0:
            # the injected degradation: a slow host/NIC stretches every
            # iteration, which is exactly what the EWMA must catch
            time.sleep(self._stall_s)
        self.beats += 1
        self.missed_beats = 0

    @property
    def serving(self) -> bool:
        return self.state == HEALTHY

    # --- health surface -----------------------------------------------------
    @property
    def slot_accounting_ok(self) -> bool:
        """Every occupied KV slot is owned by a running request.

        A leak (occupied > running) is capacity silently gone — the
        deterministic detection signal for the ``slot_leak`` fault and
        for real free-list bugs alike."""
        used = _row_ledger(self.engine).used_slots
        return used <= len(self.engine.running_requests)

    #: SLO samples a snapshot reads: the engine's lifetime lists are
    #: unbounded, and this snapshot sits on the router's per-dispatch
    #: hot path — recent samples are both cheaper (bounded sort) and
    #: the truer routing signal (a replica's pace NOW, not its history)
    SNAPSHOT_WINDOW = 256

    def stats_snapshot(self) -> dict:
        """``ServingStats.snapshot()`` with counters made monotonic for
        the REPLICA's lifetime: cumulative fields carry across re-forms
        (``_carried``), so the fleet registry's per-replica source
        never shows a counter reset mid-run.  Gauges and percentile
        summaries stay the live engine's own.  This is the fleet's
        registered metric source for the replica."""
        snap = self.engine.stats.snapshot()
        for field, base in self._carried.items():
            value = snap.get(field)
            if isinstance(value, (int, float)):
                snap[field] = value + base
        snap["generation"] = self.generation
        return snap

    def snapshot(self) -> dict:
        """The router/admission view of this replica (plain scalars,
        feeds the fleet ``MetricsRegistry`` too)."""
        if self.engine is None:
            # provisional replica mid-scale-up: visible, never routable
            return dict(name=self.name, healthy=False,
                        state=self.state, generation=self.generation,
                        role=self.role,
                        slots=0, free_slots=0, queue_depth=0,
                        running=0, ttft_p95_s=None, tpot_p50_s=None,
                        tpot_p95_s=None)
        stats = self.engine.stats
        w = self.SNAPSHOT_WINDOW
        ttft, tpot = stats.ttft_s[-w:], stats.tpot_s[-w:]
        return dict(
            name=self.name,
            healthy=self.serving and not self.crashed,
            state=self.state,
            generation=self.generation,
            role=self.role,
            slots=self.engine.num_slots,
            free_slots=self.engine.free_slots,
            queue_depth=self.engine.stats.queue_depth,
            running=len(self.engine.running_requests),
            ttft_p95_s=_pct(ttft, 95),
            tpot_p50_s=_pct(tpot, 50),
            tpot_p95_s=_pct(tpot, 95),
        )

    # --- fault surface (FleetFaultInjector) ---------------------------------
    def crash(self) -> None:
        self.crashed = True

    def inject_stall(self, seconds: float,
                     clear_at_tick: Optional[int] = None) -> None:
        """Stall every tick by ``seconds``; with ``clear_at_tick`` the
        stall clears when ``tick()`` first runs at/after that fleet
        tick, else it persists until re-form."""
        self._stall_s = float(seconds)
        self._stall_clear_tick = (
            None if clear_at_tick is None else int(clear_at_tick)
        )

    def leak_slots(self, count: int) -> int:
        """Leak ``count`` slots (allocated with no owning request).

        Whatever the pool cannot give up right now stays pending and is
        seized tick by tick as slots free — a leak against a saturated
        pool is deferred, not defeated.  Returns how many leaked
        immediately."""
        leaked = self._leak_now(max(count, 0))
        self._pending_leaks += max(count, 0) - leaked
        return leaked

    def fail_next_builds(self, count: int) -> None:
        """Force the next ``count`` :meth:`rebuild` calls to fail (the
        ``reform_failure`` chaos kind: an infeasible re-allocation, an
        OOMing builder — any rebuild the pre-flight would reject).

        The failure fires BEFORE the builder runs, so the rollback
        contract holds exactly as for a real builder failure: nothing
        is mutated, the supervisor's ``max_reforms`` budget is spent,
        and the backoff clock starts."""
        self._build_failures = max(int(count), 0)

    def _leak_now(self, count: int) -> int:
        leaked = 0
        for _ in range(count):
            slot = self.engine._allocate_slot()
            if slot is None:
                break
            self.leaked_slots.append(slot)
            leaked += 1
        return leaked

    # --- recovery -----------------------------------------------------------
    def rebuild(self) -> None:
        """Re-form: construct a FRESH engine through the same builder
        that made the original (worker-manager pre-flight included) and
        only then swap it in — a failed build leaves the old state
        untouched for the supervisor's rollback accounting."""
        if self._build_failures > 0:
            # the injected reform_failure: spend one charge and die
            # exactly where a real builder rejection would, before any
            # state is touched
            self._build_failures -= 1
            raise RuntimeError(
                f"injected build failure on replica {self.name} "
                f"({self._build_failures} more pending)"
            )
        engine = self._build()
        # bank the dying generation's cumulative counters BEFORE the
        # swap (the stats object is still readable even for a crashed
        # replica — the crash is simulated at the RPC surface), so
        # stats_snapshot() stays monotonic across the re-form.  A
        # provisional (defer_build) replica has no prior generation to
        # bank.
        if self.engine is not None:
            old = self.engine.stats
            for field in ServingStats.COUNTER_FIELDS:
                self._carried[field] = (
                    self._carried.get(field, 0) + getattr(old, field)
                )
        engine.trace_name = self.name
        self.engine = engine
        self.state = HEALTHY
        self.generation += 1
        self.crashed = False
        self._stall_s = 0.0
        self._stall_clear_tick = None
        self.leaked_slots = []
        self._pending_leaks = 0
        self.missed_beats = 0


def _row_ledger(engine: ServingEngine):
    """The engine's decode-row ledger (``used_slots``): the paged
    engine's row allocator, or stage 0's slot pool."""
    return engine._rows if engine._paged else engine.stages[0].pool


def _pct(samples, q) -> Optional[float]:
    """Percentile by nearest-rank over a small sample list (stdlib-only
    twin of the ServingStats computation; None with no samples)."""
    if not samples:
        return None
    ordered = sorted(samples)
    rank = max(0, min(len(ordered) - 1,
                      round(q / 100.0 * (len(ordered) - 1))))
    return float(ordered[int(rank)])


__all__ = [
    "DEAD",
    "DRAINING",
    "EVICTED",
    "EngineReplica",
    "HEALTHY",
    "RETIRED",
    "ReplicaCrashed",
]
