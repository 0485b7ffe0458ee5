"""Deterministic, seeded fault-injection harness (the port of
``skycomputing_tpu/dynamics/faults.py``).

The :class:`~..stimulator.Stimulator` injects *static* heterogeneity: one
seeded slowdown draw per worker, fixed for the whole run.  Real nodes
degrade *mid-run* — the case the paper's load-balanced allocation is
most exposed to — so chaos runs need faults scheduled on the training
timeline: "node 2 becomes 3x slower at iter 50", byte-for-byte
reproducible.  :class:`FaultPlan` is that script; the
:class:`FaultInjectionHook` applies it from inside the normal hook
lifecycle so no trainer code changes for a chaos run.

Event kinds (each a plain dict, so plans serialize as JSON):

``slowdown``   persistent compute degradation of one worker's stage
               (``worker`` = stable ``stim_index``, ``factor``; optional
               ``duration`` iters after which it clears).  Written to both
               the live :class:`StageRuntime` and the worker's
               ``extra_config`` so it survives a self-heal repartition —
               a degraded NODE stays degraded whatever layers it holds.
``stall``      one-shot transient wedge: the iteration sleeps ``seconds``.
``nan``        poison one worker's stage parameters with NaN (what a bad
               DIMM / bit-flip looks like by the time the loss sees it).
``drop_beat``  suppress this iteration's heartbeat collective by setting
               ``runner.fault_drop_beat``, which ``HeartbeatHook``
               consumes at a scheduled beat; a drop armed where no beat
               is scheduled is recorded ``consumed: False``, as in the
               reference.
``corrupt_checkpoint``  truncate the newest checkpoint (``*.pt``, not its
               training-state sidecar) under ``path`` to a seeded
               fraction of its bytes — a torn write as the newest
               artifact.

The serving-fleet kinds (``replica_crash``, ``latency_spike``,
``slot_leak``) are applied by :class:`FleetFaultInjector` at the start
of every ``ServingFleet.step``.

All randomness (unspecified truncation points, spike lengths) comes
from one numpy generator seeded at construction, so a plan replays
exactly and draws the reference's numbers.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..registry import HOOKS
from ..runner.hooks import Hook
from ..utils import Logger

#: trainer-timeline kinds, applied by :class:`FaultInjectionHook`
_TRAINER_KINDS = (
    "slowdown", "stall", "nan", "drop_beat", "corrupt_checkpoint",
)
#: serving-fleet kinds, applied by :class:`FleetFaultInjector`
_FLEET_KINDS = ("replica_crash", "latency_spike", "slot_leak")
_KINDS = _TRAINER_KINDS + _FLEET_KINDS

#: per-kind required event fields, validated at plan construction so a
#: malformed plan fails at build time, not 50 iterations into a chaos run
_REQUIRED_FIELDS = {
    "slowdown": ("worker", "factor"),
    "stall": ("seconds",),
    "nan": (),
    "drop_beat": (),
    "corrupt_checkpoint": ("path",),
    "replica_crash": ("replica",),
    "latency_spike": ("replica",),
    "slot_leak": ("replica",),
}


class FaultPlan:
    """An iteration-indexed script of fault events.

    ``events``: sequence of dicts with at least ``iter`` (0-based training
    iteration, matched against ``runner.iter`` at the START of that
    iteration) and ``kind`` (one of ``_KINDS``).  Events fire once, in
    listed order within an iteration.
    """

    def __init__(self, events: Sequence[Dict[str, Any]], seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.seed = seed
        self.events: List[Dict[str, Any]] = []
        for ev in events:
            ev = dict(ev)
            if "iter" not in ev:
                raise ValueError(f"fault event missing 'iter': {ev}")
            kind = ev.get("kind")
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: {_KINDS}"
                )
            missing = [f for f in _REQUIRED_FIELDS[kind] if f not in ev]
            if missing:
                raise ValueError(
                    f"fault event {ev} missing required field(s) {missing} "
                    f"for kind {kind!r}"
                )
            ev["iter"] = int(ev["iter"])
            self.events.append(ev)
        self.events.sort(key=lambda e: e["iter"])

    @classmethod
    def from_stimulator(
        cls,
        worker_num: int,
        at_iter: int = 0,
        compute_range=(1.0, 4.0),
        compute_seed: int = 42,
        seed: int = 0,
    ) -> "FaultPlan":
        """Stimulator-compatible static heterogeneity as a plan: every
        worker gets its seeded slowdown at ``at_iter`` — the same draw the
        :class:`~..stimulator.Stimulator` would produce, but applied to
        live stages on the training timeline instead of distorting the
        startup benchmark."""
        from ..stimulator import Stimulator

        stim = Stimulator(
            worker_num, compute_range=compute_range, compute_seed=compute_seed
        )
        events = [
            dict(iter=at_iter, kind="slowdown", worker=i,
                 factor=stim.compute_slowdown(i))
            for i in range(worker_num)
        ]
        return cls(events, seed=seed)

    def events_at(self, iteration: int) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["iter"] == iteration]

    def draw_fraction(self, lo: float = 0.1, hi: float = 0.9) -> float:
        """One seeded draw in [lo, hi) — the truncation point for
        checkpoint corruption when the event doesn't pin one."""
        return float(lo + (hi - lo) * self._rng.random())

    def draw_spike_seconds(self, lo: float = 0.02,
                           hi: float = 0.2) -> float:
        """One seeded draw for an unpinned ``latency_spike`` stall —
        same generator as every other draw, so a plan that leaves
        ``seconds`` open still replays byte-for-byte."""
        return self.draw_fraction(lo, hi)

    def corrupt_checkpoint(
        self, path: str, keep_fraction: Optional[float] = None
    ) -> str:
        """Truncate the newest ``*.pt`` under ``path`` (or ``path``
        itself if it's a file) to ``keep_fraction`` of its bytes.
        Returns the corrupted file's path."""
        if os.path.isdir(path):
            candidates = [
                os.path.join(path, n)
                for n in os.listdir(path)
                # exclude training-state sidecars: "newest checkpoint"
                # means the params file, and the sidecar is written last
                # so max-mtime would otherwise always pick it
                if n.endswith(".pt")
                and not n.endswith(".train_state.pt")
            ]
            if not candidates:
                raise FileNotFoundError(f"no *.pt checkpoints in {path}")
            target = max(candidates, key=os.path.getmtime)
        else:
            target = path
        size = os.path.getsize(target)
        frac = (
            float(keep_fraction)
            if keep_fraction is not None
            else self.draw_fraction()
        )
        keep = max(1, int(size * frac))
        with open(target, "rb+") as fh:
            fh.truncate(keep)
        return target


@HOOKS.register_module
class FaultInjectionHook(Hook):
    """Apply a :class:`FaultPlan` from the runner's hook lifecycle.

    Register it BEFORE detection/heal hooks so an iteration's faults are
    in place when those hooks observe it.  ``applied`` records every fired
    event (with the iteration it fired at) for test assertions.
    """

    def __init__(self, plan: FaultPlan, logger: Optional[Logger] = None):
        foreign = [e for e in plan.events if e["kind"] in _FLEET_KINDS]
        if foreign:
            raise ValueError(
                f"FaultInjectionHook applies trainer-timeline faults "
                f"only; fleet kinds {sorted({e['kind'] for e in foreign})}"
                f" belong in a FleetFaultInjector plan"
            )
        self._plan = plan
        self._logger = logger or Logger()
        # worker stim_index -> (clear_at_iter, previous_factor)
        self._pending_clear: Dict[int, Any] = {}
        # stall seconds armed in before_iter, slept in after_iter: this
        # hook registers BEFORE the detection hooks, so a before_iter
        # sleep would finish before their timers start and the wedge
        # would be invisible to exactly the detectors under test
        self._pending_stall_s = 0.0
        self.applied: List[Dict[str, Any]] = []

    # --- worker/stage resolution -------------------------------------------
    @staticmethod
    def _worker_by_stim_index(runner, stim_index: int):
        for w in runner.worker_manager.worker_pool:
            if w.stim_index == stim_index:
                return w
        raise LookupError(f"no worker with stim_index {stim_index}")

    @staticmethod
    def _stage_for_worker(runner, worker):
        """The live StageRuntime holding ``worker``'s slice, or None when
        the worker currently holds no layers."""
        occupied = [
            w
            for w in sorted(
                runner.worker_manager.worker_pool, key=lambda w: w.rank
            )
            if w.model_config
        ]
        for stage_idx, w in enumerate(occupied):
            if w is worker:
                return runner.model.stages[stage_idx]
        return None

    def _set_worker_slowdown(self, runner, stim_index: int,
                             factor: float) -> None:
        worker = self._worker_by_stim_index(runner, stim_index)
        # extra_config is the durable home: PipelineModel._build_stages
        # reads it on every (re)build, so the degradation survives a
        # self-heal repartition
        worker.extra_config["slowdown"] = float(factor)
        stage = self._stage_for_worker(runner, worker)
        if stage is not None:
            stage.slowdown = float(factor)

    # --- lifecycle ----------------------------------------------------------
    def before_iter(self, runner):
        # drop_beat is one-shot per iteration: clear the PREVIOUS
        # iteration's flag here (not in after_iter — this hook registers
        # before the detection hooks, so its after_iter would clear the
        # flag before HeartbeatHook ever saw it).  A consuming
        # HeartbeatHook resets the flag itself; finding it still set
        # means no beat was scheduled that iteration (interval mismatch)
        # — record that honestly instead of letting a chaos test believe
        # a beat was suppressed.
        if getattr(runner, "fault_drop_beat", False):
            for rec in reversed(self.applied):
                if rec["kind"] == "drop_beat":
                    rec["consumed"] = False
                    break
            self._logger.info(
                "FAULT: armed drop_beat was never consumed (no heartbeat "
                "scheduled that iteration)"
            )
        runner.fault_drop_beat = False

        # clear expired slowdowns first so a back-to-back re-injection at
        # the same iteration wins
        for stim_index, (clear_at, prev) in list(self._pending_clear.items()):
            if runner.iter >= clear_at:
                self._set_worker_slowdown(runner, stim_index, prev)
                del self._pending_clear[stim_index]

        for ev in self._plan.events_at(runner.iter):
            kind = ev["kind"]
            if kind == "slowdown":
                stim_index = int(ev["worker"])
                factor = float(ev["factor"])
                if ev.get("duration"):
                    worker = self._worker_by_stim_index(runner, stim_index)
                    prev = float(worker.extra_config.get("slowdown", 1.0))
                    self._pending_clear[stim_index] = (
                        runner.iter + int(ev["duration"]), prev
                    )
                self._set_worker_slowdown(runner, stim_index, factor)
                self._logger.info(
                    f"FAULT iter {runner.iter}: worker {stim_index} "
                    f"compute slowdown x{factor}"
                )
            elif kind == "stall":
                self._pending_stall_s += float(ev["seconds"])
                self._logger.info(
                    f"FAULT iter {runner.iter}: transient stall "
                    f"{float(ev['seconds']):.3f}s armed"
                )
            elif kind == "nan":
                worker = self._worker_by_stim_index(
                    runner, int(ev.get("worker", 0))
                )
                stage = self._stage_for_worker(runner, worker)
                if stage is None:
                    # don't lie in the log or the applied record: a chaos
                    # test asserting the NaN path ran must see the skip
                    self._logger.info(
                        f"FAULT iter {runner.iter}: worker "
                        f"{ev.get('worker', 0)} holds no layers; nan "
                        f"fault skipped"
                    )
                    ev = dict(ev, skipped=True)
                else:
                    with torch.no_grad():
                        for p in stage.parameters:
                            p.mul_(float("nan"))
                    self._logger.info(
                        f"FAULT iter {runner.iter}: NaN-poisoned worker "
                        f"{ev.get('worker', 0)} params"
                    )
            elif kind == "drop_beat":
                runner.fault_drop_beat = True
                self._logger.info(
                    f"FAULT iter {runner.iter}: heartbeat drop armed"
                )
            elif kind == "corrupt_checkpoint":
                target = self._plan.corrupt_checkpoint(
                    ev["path"], ev.get("keep_fraction")
                )
                self._logger.info(
                    f"FAULT iter {runner.iter}: truncated checkpoint "
                    f"{target}"
                )
            self.applied.append(dict(ev, fired_at=runner.iter))

    def after_iter(self, runner):
        if self._pending_stall_s > 0.0:
            # inside the detection hooks' timing window (they registered
            # after this hook, so their after_iter runs after this sleep)
            time.sleep(self._pending_stall_s)
            self._pending_stall_s = 0.0


class FleetFaultInjector:
    """Apply a :class:`FaultPlan`'s fleet vocabulary to a serving fleet.

    The fleet twin of :class:`FaultInjectionHook`: the fleet calls
    :meth:`on_tick` at the START of every :meth:`ServingFleet.step`
    (before any replica runs and before the supervisor observes), so an
    event at tick N is in place when tick N's detection looks.  The
    target is duck-typed — anything with ``tick`` and
    ``replica_by_index(i)`` returning objects exposing ``crash()`` /
    ``inject_stall(seconds, duration_ticks)`` / ``leak_slots(count)``
    (:class:`~..fleet.replica.EngineReplica`'s fault surface) — which
    keeps dynamics -> fleet import-free.

    ``applied`` records every fired event with the tick it fired at and
    any seeded draw it consumed, for test assertions.
    """

    def __init__(self, plan: FaultPlan, logger: Optional[Logger] = None):
        foreign = [e for e in plan.events
                   if e["kind"] not in _FLEET_KINDS]
        if foreign:
            raise ValueError(
                f"FleetFaultInjector applies fleet faults only; trainer "
                f"kinds {sorted({e['kind'] for e in foreign})} belong in "
                f"a FaultInjectionHook plan"
            )
        self._plan = plan
        self._logger = logger or Logger()
        self.applied: List[Dict[str, Any]] = []
        self._validated = False

    def on_tick(self, fleet) -> None:
        if not self._validated:
            # the fleet is first available HERE, so replica indices are
            # range-checked on the first tick — before anything fires —
            # keeping the fails-at-arm-time contract the kind/field
            # validation makes at construction
            self._validated = True
            n = len(fleet.replicas)
            bad = sorted({
                int(e["replica"]) for e in self._plan.events
                if not 0 <= int(e["replica"]) < n
            })
            if bad:
                raise ValueError(
                    f"fault plan names replica indices {bad} but the "
                    f"fleet has {n} replicas"
                )
        for ev in self._plan.events_at(fleet.tick):
            kind = ev["kind"]
            replica = fleet.replica_by_index(int(ev["replica"]))
            if kind == "replica_crash":
                replica.crash()
                self._logger.info(
                    f"FAULT tick {fleet.tick}: replica {replica.name} "
                    f"crashed"
                )
            elif kind == "latency_spike":
                seconds = ev.get("seconds")
                if seconds is None:
                    seconds = self._plan.draw_spike_seconds()
                    ev = dict(ev, seconds=float(seconds))
                duration = ev.get("duration")
                replica.inject_stall(
                    float(seconds),
                    None if duration is None
                    else fleet.tick + int(duration),
                )
                self._logger.info(
                    f"FAULT tick {fleet.tick}: replica {replica.name} "
                    f"latency spike {float(seconds):.3f}s/tick"
                    + (f" for {duration} ticks" if duration else "")
                )
            elif kind == "slot_leak":
                want = int(ev.get("count", 1))
                leaked = replica.leak_slots(want)
                if leaked < want:
                    # an exhausted pool leaks fewer — record the truth
                    ev = dict(ev, leaked=leaked)
                self._logger.info(
                    f"FAULT tick {fleet.tick}: replica {replica.name} "
                    f"leaked {leaked} slot(s)"
                )
            self.applied.append(dict(ev, fired_at=fleet.tick))


__all__ = ["FaultPlan", "FaultInjectionHook", "FleetFaultInjector"]
