"""AutotuneHook: the training-side actuator of the closed tuning loop (the
port of ``skycomputing_tpu/runner/hooks_collection/autotune_hook.py``).

``SelfHealHook`` reacts to *degradation* (a node got slower mid-run);
this hook pursues *improvement*: every ``tune_every`` iterations it
reads the trace window the run just produced, asks the
:class:`~...tuning.TuningAdvisor` whether the window carries a known
inefficiency signature, and — if so — changes the proposed knob
(schedule, microbatch count, or the layer allocation itself) with the
full verify-then-apply contract:

1. the proposal passes a pre-flight verifier BEFORE taking effect —
   knob proposals through ``verify_tuning_knobs``, allocation proposals
   through the full ``verify_plan`` (units built and run on ``meta``)
   against the re-solved partition (a rejected proposal restores the partition AND the
   allocator's calibration, then blocks the signature);
2. allocation changes apply through the self-heal in-process rebuild
   path (``model.rebuild()`` + ``runner.rearm_preflight()``), so the
   Runner re-verifies the new plan before its first train step exactly
   as it verified the original;
3. the NEXT window must show the step time improving by at least
   ``min_improvement`` or the change rolls back and the signature is
   blocked — the loop converges instead of thrashing.

The hook measures step wall time itself (host ``perf_counter`` per
iteration), so it needs no ``TraceHook`` to judge improvement.  Each
iteration's window ends after ``PipelineModel.train_step`` returned,
which is after the pipeline's own device barrier (``_synchronize`` in
``parallel/pipeline.py``): on the card the time is the step's, not its
issue's.  It does need tracing enabled for the per-stage busy
signatures; if no tracer is active at ``before_run`` it enables one and
owns it.

Do not register this hook together with ``SelfHealHook`` pointing at
the same allocator: both would fold measured divergence into the same
device model and double-correct.  Pick one — SelfHealHook for
supervised multi-process worlds (it can exit for re-forms), AutotuneHook
for single-controller runs where schedule/microbatch knobs are also in
play.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ...registry import HOOKS
from ...telemetry import disable_tracing, enable_tracing, get_tracer
from ...telemetry.analysis import TraceError, analyze
from ...tuning.advisor import Proposal, TuningAdvisor, _median
from ...tuning.autotune import (
    APPLIED,
    COMMITTED,
    NO_OP,
    REJECTED,
    ROLLED_BACK,
    improved,
    restore_partition,
    snapshot_partition,
    window_events,
)
from ..hooks import Hook


@HOOKS.register_module
class AutotuneHook(Hook):
    """Trace-driven knob search over a live training run.

    ``allocator`` must be the one that produced the current allocation
    (same contract as ``SelfHealHook``); without it, allocation
    proposals are reported but skipped.  ``events`` records every
    analyze/apply/commit/rollback with its iteration, for tests and
    post-mortems; ``tunes`` counts committed improvements.
    """

    def __init__(
        self,
        allocator=None,
        advisor: Optional[TuningAdvisor] = None,
        tune_every: int = 8,
        max_tunes: int = 3,
        min_improvement: float = 0.03,
        damping: float = 1.0,
        solver_time_s: float = 10.0,
    ):
        if tune_every < 2:
            # the settle window needs at least one clean iteration after
            # an apply (the first post-rebuild step warms fresh stages)
            raise ValueError(f"tune_every must be >= 2, got {tune_every}")
        self._allocator = allocator
        self._advisor = advisor or TuningAdvisor()
        self._tune_every = int(tune_every)
        self._max_tunes = int(max_tunes)
        self._min_improvement = float(min_improvement)
        self._damping = float(damping)
        self._solver_time_s = float(solver_time_s)

        self.tunes = 0
        self.events: List[Dict[str, Any]] = []
        self.blocked: set = set()
        self._tracer = None
        self._owned = False
        self._warmed = False
        self._pending: Optional[Dict[str, Any]] = None
        self._window_t0: Optional[float] = None
        self._window_times: List[float] = []
        self._iter_t0: Optional[float] = None
        self._arc_id = 0

    # --- run lifecycle ------------------------------------------------------
    def before_run(self, runner):
        model = runner.model
        if not (hasattr(model, "schedule")
                and hasattr(model, "num_microbatches")
                and hasattr(model, "rebuild")):
            # a model type without the training knobs (e.g. a
            # DataParallelPipeline wrapper) has nothing this hook can
            # actuate — stand down for the whole run instead of
            # crashing the first analysis cycle
            self.events.append(dict(
                outcome="unsupported_model",
                model=type(model).__name__,
            ))
            runner.logger.info(
                f"AutotuneHook: {type(model).__name__} exposes no "
                f"tuning knobs; hook disarmed for this run"
            )
            self._tracer = None
            return
        tracer = get_tracer()
        if tracer is None:
            tracer = enable_tracing()
            self._owned = True
        self._tracer = tracer
        self._window_t0 = tracer.now()
        self._window_times = []
        self._iter_t0 = None
        self._warmed = False
        self._pending = None  # after_run settled any leftover as "unsettled"

    def after_run(self, runner):
        if self._pending is not None:
            # a proposal applied in the final window was never measured
            # against a comparable window: it stands (rolling back on no
            # evidence would be just as arbitrary), but the arc must
            # close and the record must say so — no silent outcomes
            pending = self._pending
            self._pending = None
            proposal: Proposal = pending["proposal"]
            self._record(runner, "unsettled",
                         proposal=proposal.describe(),
                         base_ms=pending["base_ms"])
            if self._tracer is not None:
                self._tracer.async_end(
                    "autotune", self._lane(), pending["arc_id"],
                    {"outcome": "unsettled"},
                )
        if self._owned:
            disable_tracing()
        self._tracer = None
        self._owned = False

    # --- iteration accounting ----------------------------------------------
    def before_iter(self, runner):
        self._iter_t0 = time.perf_counter()

    def after_iter(self, runner):
        if self._tracer is None or self._iter_t0 is None:
            return
        self._window_times.append(time.perf_counter() - self._iter_t0)
        self._iter_t0 = None
        if len(self._window_times) < self._tune_every:
            return
        if not self._warmed:
            # the first window holds the warm-up iterations (kernel
            # library loads, the allocator's first blocks) — analysis
            # over it would read warmup as bubble and propose against a
            # phantom signature
            self._warmed = True
            self._record(runner, "warmup")
        else:
            self._cycle(runner)
        self._window_t0 = self._tracer.now()
        self._window_times = []

    # --- bookkeeping --------------------------------------------------------
    def _record(self, runner, outcome: str, **extra) -> None:
        self.events.append(
            dict(outcome=outcome, iter=runner.iter, epoch=runner.epoch,
                 **extra)
        )

    def _lane(self):
        return self._tracer.lane("autotune", "loop")

    # --- the loop -----------------------------------------------------------
    def _cycle(self, runner) -> None:
        tracer = self._tracer
        # same median the advisor uses for its straggler ratio, so the
        # commit/rollback metric can never drift from the decide step
        step_p50_ms = _median(self._window_times) * 1e3
        with tracer.span("autotune.analyze", self._lane(),
                         {"iters": len(self._window_times),
                          "step_p50_ms": step_p50_ms}):
            try:
                report = analyze(window_events(tracer, self._window_t0))
            except TraceError as exc:
                self._record(runner, "unanalyzable", error=str(exc))
                return
        if self._pending is not None:
            # the window's first iteration paid the proposal's rebuild
            # (fresh stages, their first allocations); judging on it
            # would read every good change as a regression, so the
            # settle median is over the remaining, clean iterations
            settle = self._window_times[1:] or self._window_times
            self._settle(runner, _median(settle) * 1e3)
            return
        if self.tunes >= self._max_tunes:
            return
        batch_size = None
        if runner.current_batch is not None:
            data = runner.current_batch[0]
            leaf = data[0] if isinstance(data, (tuple, list)) else data
            batch_size = int(leaf.shape[0])
        proposal = self._advisor.propose_training(
            report,
            schedule=runner.model.schedule,
            num_microbatches=runner.model.num_microbatches,
            batch_size=batch_size,
            steps=len(self._window_times),
            blocked=self.blocked,
        )
        if proposal is None:
            self._record(runner, NO_OP,
                         bubble=report.get("bubble_fraction"))
            return
        self._apply(runner, proposal, step_p50_ms)

    # --- apply (verify first) ----------------------------------------------
    def _apply(self, runner, proposal: Proposal,
               step_p50_ms: float) -> None:
        tracer = self._tracer
        self._arc_id += 1
        tracer.async_begin("autotune", self._lane(), self._arc_id,
                           proposal.describe())
        with tracer.span("autotune.apply", self._lane(),
                         proposal.describe()):
            revert = self._verify_and_apply(runner, proposal)
        if revert is None:  # rejected — _verify_and_apply recorded why
            self.blocked.add(proposal.signature)
            tracer.async_end("autotune", self._lane(), self._arc_id,
                             {"outcome": REJECTED})
            return
        self._pending = dict(proposal=proposal, base_ms=step_p50_ms,
                             revert=revert, arc_id=self._arc_id)
        self._record(runner, APPLIED, proposal=proposal.describe(),
                     base_ms=step_p50_ms)
        runner.logger.info(
            f"AutotuneHook: applied {proposal.signature} at iter "
            f"{runner.iter} ({proposal.reason}); verifying next window"
        )

    def _verify_and_apply(self, runner, proposal: Proposal):
        """Verify the proposal, apply it, and return a revert closure —
        or record the rejection and return None (system untouched)."""
        from ...analysis.plan_check import (
            PlanError,
            verify_plan,
            verify_tuning_knobs,
        )

        model = runner.model
        if proposal.knob == "schedule":
            report = verify_tuning_knobs(
                schedule=proposal.value,
                num_microbatches=model.num_microbatches,
            )
            if not report.ok:
                self._reject(runner, proposal, report)
                return None
            old = model.schedule
            model.schedule = proposal.value

            def revert():
                model.schedule = old

            return revert

        if proposal.knob == "microbatches":
            batch_size = None
            if runner.current_batch is not None:
                data = runner.current_batch[0]
                leaf = data[0] if isinstance(data, (tuple, list)) else data
                batch_size = int(leaf.shape[0])
            report = verify_tuning_knobs(
                num_microbatches=proposal.value, batch_size=batch_size,
            )
            if not report.ok:
                self._reject(runner, proposal, report)
                return None
            old = model.num_microbatches
            model.num_microbatches = int(proposal.value)

            def revert():
                model.num_microbatches = old

            return revert

        if proposal.knob == "allocation":
            if self._allocator is None:
                self._record(runner, REJECTED,
                             proposal=proposal.describe(),
                             error="no allocator wired to AutotuneHook")
                return None
            allocator = self._allocator
            wm = runner.worker_manager
            partition = snapshot_partition(wm)
            calibration = allocator.snapshot_calibration()
            # a mesh-native model re-solves the MESH SHAPE (layer slices
            # AND chips-per-stage) instead of the heterogeneous-device
            # partition: a straggler stage sheds layers or gains chips,
            # actuated through the same verify-then-apply rebuild path
            mesh_native = (
                hasattr(model, "chips_per_stage")
                and hasattr(allocator, "refine_mesh_allocation")
            )

            def undo():
                restore_partition(wm, partition)
                allocator.restore_calibration(calibration)

            try:
                if mesh_native:
                    from ...analysis.plan_check import (
                        PlanIssue,
                        verify_mesh_payload,
                    )

                    allocator.refine_mesh_allocation(
                        list(proposal.value), damping=self._damping,
                        # the ENGINE's live chips, not the pool's: a
                        # model built with an explicit chips_per_stage
                        # argument has no mesh_chips on its workers and
                        # the default-1 fallback would de-scale wide
                        # stages wrong
                        chips=list(model.chips_per_stage),
                    )
                    payload = {
                        "chips_per_stage": [
                            int(w.extra_config.get("mesh_chips", 1))
                            for w in wm.worker_pool if w.model_config
                        ],
                        "num_devices": len(model._devices),
                        "tp": getattr(model, "_tp", 1),
                    }
                    if runner.current_batch is not None:
                        data = runner.current_batch[0]
                        leaf = (data[0] if isinstance(data, (tuple, list))
                                else data)
                        payload["microbatch_rows"] = max(
                            int(leaf.shape[0])
                            // max(model.num_microbatches, 1), 1,
                        )
                    problems = verify_mesh_payload(payload)
                    if problems:
                        raise PlanError([
                            PlanIssue("mesh", "error", p)
                            for p in problems
                        ])
                else:
                    allocator.refine_allocation(
                        list(proposal.value),
                        damping=self._damping,
                        max_time=self._solver_time_s,
                        attribute="devices",
                    )
                if runner.current_batch is not None:
                    verify_plan(
                        allocator.model_config, wm,
                        runner.current_batch[0],
                    ).raise_if_failed()
            except (PlanError, ValueError, RuntimeError) as exc:
                undo()
                self._record(runner, REJECTED,
                             proposal=proposal.describe(),
                             error=str(exc))
                runner.logger.info(
                    f"AutotuneHook: rejected {proposal.signature}: {exc}"
                )
                return None
            # the verified plan applies through the same path a
            # self-heal re-allocation does
            model.rebuild()
            runner.rearm_preflight()

            def revert():
                undo()
                model.rebuild()
                runner.rearm_preflight()

            return revert

        self._record(runner, REJECTED, proposal=proposal.describe(),
                     error=f"unknown knob {proposal.knob!r}")
        return None

    def _reject(self, runner, proposal: Proposal, report) -> None:
        errors = "; ".join(i.message for i in report.errors)
        self._record(runner, REJECTED, proposal=proposal.describe(),
                     error=errors)
        runner.logger.info(
            f"AutotuneHook: rejected {proposal.signature}: {errors}"
        )

    # --- settle (commit or roll back) ---------------------------------------
    def _settle(self, runner, step_p50_ms: float) -> None:
        tracer = self._tracer
        pending = self._pending
        proposal: Proposal = pending["proposal"]
        base_ms = pending["base_ms"]
        if improved(base_ms, step_p50_ms, self._min_improvement):
            self.tunes += 1
            self._pending = None
            self._record(runner, COMMITTED, proposal=proposal.describe(),
                         base_ms=base_ms, new_ms=step_p50_ms)
            tracer.async_end("autotune", self._lane(), pending["arc_id"],
                             {"outcome": COMMITTED})
            runner.logger.info(
                f"AutotuneHook: committed {proposal.signature} (step p50 "
                f"{base_ms:.1f} -> {step_p50_ms:.1f} ms)"
            )
            return
        with tracer.span("autotune.rollback", self._lane(),
                         proposal.describe()):
            pending["revert"]()
        self.blocked.add(proposal.signature)
        self._pending = None
        self._record(runner, ROLLED_BACK, proposal=proposal.describe(),
                     base_ms=base_ms, new_ms=step_p50_ms)
        tracer.async_end("autotune", self._lane(), pending["arc_id"],
                         {"outcome": ROLLED_BACK})
        runner.logger.info(
            f"AutotuneHook: rolled back {proposal.signature} (step p50 "
            f"{base_ms:.1f} -> {step_p50_ms:.1f} ms, no improvement)"
        )


__all__ = ["AutotuneHook"]
