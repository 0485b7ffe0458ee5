"""Straggler-triggered re-allocation (the port of
``skycomputing_tpu/runner/hooks_collection/selfheal_hook.py``).

The paper's speedup assumes the startup benchmark stays true, yet in
the geo-distributed setting it models, nodes slow down mid-run.  Detection alone (``WatchdogHook`` flags slow
iterations) leaves the schedule bottlenecked on the straggler forever.

``SelfHealHook`` closes the loop:

1. **Detect** — per-iteration wall time folded into an EWMA, windowed;
   after ``k_windows`` consecutive windows diverging ≥ ``threshold`` from
   the healthy baseline, the run is declared degraded.  This trigger is
   free (two ``perf_counter`` calls per iteration); per-stage measurement
   only happens on suspicion.
2. **Confirm** — a real per-stage measurement pass
   (``PipelineModel.measure_stage_times``, which reflects emulated
   degradation) compared against the allocator's cost model
   (``Allocator.stage_divergence``): if no single stage diverges, the
   slowdown is global (dataloader, host contention) and re-allocating
   would not help — the hook stands down instead of thrashing.
3. **Heal** — snapshot to the parameter server (layer-indexed checkpoints
   are partition-independent), fold the measured divergence into the
   DEVICE model (``refine_allocation(attribute="devices")``), and
   repartition:

   - ``mode="inprocess"`` (single-controller): rebuild the pipeline in
     place and keep training — optimizer momentum is the documented cost,
     exactly as for elastic membership changes.
   - ``mode="exit"`` (supervised multi-process): persist the params
     snapshot, stage the measured device scales in the rendezvous dir,
     and exit with :data:`~...parallel.elastic.REALLOC_RC` — the
     supervisor treats it as a PLANNED re-form and carries the scales to
     every relaunched trainer through ``world.json``.

After the rebuild the hook re-arms the runner's pre-flight, so the new
plan is verified before its first step, and it traces the heal as an
async ``self_heal`` arc with ``selfheal.measure`` and
``selfheal.rebuild`` spans.  On the card the iteration clock and the
measurement are real wall time: the rebuild frees the old stages'
tensors before it builds the new ones (``PipelineModel.rebuild``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ...registry import HOOKS
from ...telemetry import get_tracer, trace_span
from ..hooks import Hook


@HOOKS.register_module
class SelfHealHook(Hook):
    """Keep the allocation honest against live training telemetry.

    ``allocator`` must be the one that produced the current allocation
    (it owns the cost model and the worker manager).  ``events`` records
    every detection/heal/stand-down with its iteration, for tests and
    post-mortems; ``heals`` counts completed re-allocations.
    """

    def __init__(
        self,
        allocator,
        ewma_alpha: float = 0.4,
        window: int = 4,
        threshold: float = 1.5,
        k_windows: int = 2,
        baseline_windows: int = 2,
        grace_iters: int = 2,
        max_heals: int = 3,
        confirm_threshold: float = 1.3,
        damping: float = 1.0,
        solver_time_s: float = 10.0,
        measure_repeats: int = 1,
        measure_inner: int = 1,
        mode: str = "inprocess",
        snapshot_path: Optional[str] = None,
        rendezvous_dir: Optional[str] = None,
        clock=None,
    ):
        if mode not in ("inprocess", "exit"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "exit" and not snapshot_path:
            # exit mode abandons the in-memory parameter server with the
            # process — without a persisted snapshot the relaunched
            # trainer would silently lose everything since the last
            # periodic checkpoint
            raise ValueError("mode='exit' requires snapshot_path")
        if window < 1 or k_windows < 1 or baseline_windows < 1:
            raise ValueError(
                "window, k_windows and baseline_windows must be >= 1"
            )
        self._allocator = allocator
        self._alpha = float(ewma_alpha)
        self._window = int(window)
        self._threshold = float(threshold)
        self._k_windows = int(k_windows)
        self._baseline_windows = int(baseline_windows)
        self._grace_iters = int(grace_iters)
        self._max_heals = int(max_heals)
        self._confirm_threshold = float(confirm_threshold)
        self._damping = float(damping)
        self._solver_time_s = float(solver_time_s)
        self._measure_repeats = int(measure_repeats)
        self._measure_inner = int(measure_inner)
        self._mode = mode
        self._snapshot_path = snapshot_path
        self._rendezvous_dir = rendezvous_dir
        # injectable iteration clock: detection compares wall times, so
        # under heavy host load the EWMA trigger can read every iteration
        # as slow (or the baseline as already-degraded).  Tests inject a
        # deterministic clock tied to the emulated fault instead of
        # racing the real one (the observed tier-1 flake).
        self._clock = clock if clock is not None else time.perf_counter

        self.heals = 0
        self.events: List[Dict[str, Any]] = []
        self._disarmed = False
        self._arc_id = 0  # trace async-arc id, one per heal attempt
        self._reset_telemetry()

    # --- telemetry ----------------------------------------------------------
    def _reset_telemetry(self) -> None:
        """Forget the current era: after a heal (or at start) the first
        iterations warm fresh stages (allocator, library handles) and
        must not poison the baseline, so grace re-applies and the
        baseline re-learns."""
        self._ewma: Optional[float] = None
        self._baseline: Optional[float] = None
        self._baseline_means: List[float] = []
        self._seen_iters = 0
        self._window_accum: List[float] = []
        self._streak = 0
        self._started: Optional[float] = None

    def before_iter(self, runner):
        self._started = self._clock()

    def after_iter(self, runner):
        if self._disarmed or self._started is None:
            return
        elapsed = self._clock() - self._started
        self._started = None
        self._seen_iters += 1
        if self._seen_iters <= self._grace_iters:
            return  # warm-up iterations
        self._ewma = (
            elapsed
            if self._ewma is None
            else self._alpha * elapsed + (1.0 - self._alpha) * self._ewma
        )
        self._window_accum.append(elapsed)
        if len(self._window_accum) < self._window:
            return
        window_mean = sum(self._window_accum) / len(self._window_accum)
        self._window_accum = []
        if self._baseline is None:
            # "normal" is the MINIMUM over the first ``baseline_windows``
            # windows of the era: a one-off hiccup (GC pause, noisy
            # neighbor) inflating a single window must not set a baseline
            # so high that a real 2-3x straggler reads as healthy forever
            self._baseline_means.append(window_mean)
            if len(self._baseline_means) >= self._baseline_windows:
                self._baseline = min(self._baseline_means)
                self._baseline_means = []
            return
        # a window counts as divergent only when BOTH the current window
        # mean (instantaneous) and the EWMA (sustained level) exceed the
        # threshold: the EWMA's memory rejects a single spiky window, a
        # clean window mean rejects a decaying transient's tail — one
        # stall can never stack a streak, a real straggler trips both
        # every window
        cutoff = self._threshold * self._baseline
        if window_mean > cutoff and self._ewma > cutoff:
            self._streak += 1
        else:
            self._streak = 0
            # healthy windows correct the baseline: instantly downward
            # (a faster observation is always a truer "normal"), slowly
            # upward so slow secular change (bigger batches later in a
            # curriculum) is not mistaken for degradation
            self._baseline = min(
                window_mean,
                (1.0 - self._alpha) * self._baseline
                + self._alpha * window_mean,
            )
        if self._streak < self._k_windows:
            return
        self._streak = 0
        if self.heals >= self._max_heals:
            # record once and disarm: a permanent post-heal straggler
            # would otherwise append an event every k_windows windows for
            # the rest of the run (unbounded events growth + log spam)
            self._record(runner, "exhausted", window_mean=window_mean,
                         ewma=self._ewma)
            runner.logger.info(
                f"SelfHealHook: degradation persists but max_heals="
                f"{self._max_heals} reached; disarming"
            )
            self._disarmed = True
            return
        self._heal(runner, window_mean)

    def _record(self, runner, kind: str, **extra) -> None:
        self.events.append(
            dict(kind=kind, iter=runner.iter, epoch=runner.epoch, **extra)
        )

    # --- healing ------------------------------------------------------------
    def _arc_end(self, runner, outcome: str) -> None:
        """Close this heal attempt's async trace arc (opened in _heal)."""
        tracer = get_tracer()
        if tracer is not None:
            tracer.async_end(
                "self_heal", tracer.lane("selfheal", "arc"),
                self._arc_id, {"outcome": outcome, "iter": runner.iter},
            )

    def _heal(self, runner, window_mean: float) -> None:
        runner.logger.info(
            f"SelfHealHook: sustained degradation at iter {runner.iter} "
            f"(window mean {window_mean:.4f}s, EWMA {self._ewma:.4f}s, "
            f"baseline {self._baseline:.4f}s); measuring stages"
        )
        # the detect -> measure -> re-allocate -> rebuild arc spans many
        # iterations of other work, so it is an ASYNC trace arc: opened
        # here at detection, closed by _arc_end on every exit path
        self._arc_id += 1
        tracer = get_tracer()
        if tracer is not None:
            tracer.async_begin(
                "self_heal", tracer.lane("selfheal", "arc"), self._arc_id,
                {"iter": runner.iter, "window_mean_s": window_mean},
            )
        if runner.current_batch is None:
            self._record(runner, "no_probe_batch")
            self._arc_end(runner, "no_probe_batch")
            return
        data, _ = runner.current_batch
        with trace_span("selfheal.measure", "selfheal", "phases"):
            measured = runner.model.measure_stage_times(
                data,
                repeats=self._measure_repeats,
                inner_iters=self._measure_inner,
            )
        divergence = self._allocator.stage_divergence(measured)
        worst = max(divergence.values()) if divergence else 1.0
        if worst < self._confirm_threshold:
            # the slowdown is uniform across stages: a re-allocation
            # cannot remove a global cause — stand down, re-baseline
            runner.logger.info(
                f"SelfHealHook: no straggler confirmed (worst stage "
                f"divergence {worst:.2f}x < {self._confirm_threshold}x); "
                f"standing down"
            )
            self._record(runner, "stand_down", divergence=divergence,
                         measured=list(measured))
            self._arc_end(runner, "stand_down")
            self._reset_telemetry()
            return

        # snapshot BEFORE touching the allocation: layer-indexed, so the
        # checkpoint restores under whatever partition comes next
        runner.model.sync_to_parameter_server()
        if self._snapshot_path:
            runner.parameter_server.save_weights_to_file(self._snapshot_path)
            runner.logger.info(
                f"SelfHealHook: snapshot saved to {self._snapshot_path}"
            )

        if self._mode == "exit":
            self._exit_for_realloc(runner, measured, divergence)
            return  # pragma: no cover - _exit_for_realloc raises

        old_partition = runner.model.partition_signature()
        self._allocator.refine_allocation(
            measured,
            damping=self._damping,
            max_time=self._solver_time_s,
            attribute="devices",
        )
        with trace_span("selfheal.rebuild", "selfheal", "phases"):
            runner.model.rebuild()
        # the world changed: re-arm the runner's pre-flight so the NEW
        # plan is abstractly verified before its first train step — a
        # broken re-allocation must surface as a diagnostic, not as a
        # failure inside a stage
        runner.rearm_preflight()
        self.heals += 1
        self._record(
            runner, "heal",
            divergence=divergence,
            measured=list(measured),
            old_partition=old_partition,
            new_partition=runner.model.partition_signature(),
        )
        runner.logger.info(
            f"SelfHealHook: re-allocated {old_partition} -> "
            f"{runner.model.partition_signature()} (divergence "
            f"{ {k: round(v, 2) for k, v in divergence.items()} })"
        )
        self._arc_end(runner, "healed")
        self._reset_telemetry()

    def _exit_for_realloc(self, runner, measured, divergence) -> None:
        from ...parallel.elastic import REALLOC_RC, FileRendezvous

        rdv_dir = self._rendezvous_dir or os.environ.get("SKYTPU_RENDEZVOUS")
        # fold this round's divergence into the allocator's override, then
        # stage the CUMULATIVE scales: the relaunched trainer's allocator
        # starts fresh, so a payload carrying only the latest round would
        # drop every earlier correction (a node that degraded 3x then 2x
        # more would be modeled as 2x, not 6x)
        self._allocator.calibrate_device_speeds(
            measured, damping=self._damping
        )
        payload = {
            "device_scale": {
                str(k): float(v)
                for k, v in self._allocator.device_scales().items()
            },
            "measured_stage_times": [float(t) for t in measured],
            "epoch": runner.epoch,
            "iter": runner.iter,
        }
        if rdv_dir:
            node_id = int(os.environ.get("SKYTPU_PROCESS_ID", "0"))
            FileRendezvous(rdv_dir, node_id).stage_payload(payload)
            runner.logger.info(
                f"SelfHealHook: staged realloc payload in {rdv_dir}"
            )
        else:
            runner.logger.info(
                "SelfHealHook: no rendezvous dir (SKYTPU_RENDEZVOUS unset); "
                "exiting for re-allocation without a staged payload"
            )
        self.heals += 1
        self._record(runner, "heal_exit", divergence=divergence,
                     measured=[float(t) for t in measured],
                     payload=json.loads(json.dumps(payload)))
        runner.logger.info(
            f"SelfHealHook: exiting rc={REALLOC_RC} for supervised "
            f"re-allocation"
        )
        self._arc_end(runner, "heal_exit")
        # SystemExit is not an Exception: Runner's abort detection leaves
        # ``aborted`` False (the params are fine — we just snapshotted),
        # after_run hooks still flush, and the supervisor sees REALLOC_RC
        raise SystemExit(REALLOC_RC)


__all__ = ["SelfHealHook"]
