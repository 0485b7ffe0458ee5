"""The training loop (the port of ``skycomputing_tpu/runner/runner.py``).

An epoch/iteration loop over a dataloader of ``(data, labels)`` pairs
with hook dispatch and per-phase wall-clock records: each iteration is
one ``PipelineModel.train_step`` under a step generator drawn from the
runner's own ``torch.Generator`` (seeded with ``seed``), so seeded runs
replay exactly.  ``max_iters`` and :meth:`Runner.request_stop` end the
run after the current iteration; an epoch cut short is neither counted
nor announced to ``after_train_epoch``.

:meth:`Runner.evaluate` scores a loader with the pipeline's eval-mode
forward (no dropout, no rematerialization) under the ``*_val_*`` hook
lifecycle: mean loss weighted per example, accuracy, and a GLUE task's
own metrics.

Before the first ``train_step`` (and again after anything re-arms it,
such as a self-heal rebuild) the runner verifies the pipeline's plan on
the batch in hand (``analysis/plan_check.py``: coverage, boundary
shapes on ``meta``, memory, the backward's cotangents) under a
``preflight`` span; a rejected plan raises ``PlanError`` before any
stage runs.  ``preflight=False`` or ``SKYTPU_PREFLIGHT=0`` opts out.

``self.metrics`` (a ``MetricsRegistry``) reads the pipeline's per-step
``PipelineStats`` under ``"pipeline"``; ``enable_timeseries()`` samples
it once per iteration.  The HTTP exporter is queue A item 4.  The JAX
runner's compile cache has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..analysis.plan_check import has_plan, verify_pipeline
from ..dynamics import ParameterServer, WorkerManager
from ..ops import build_loss
from ..parallel import PipelineModel
from ..telemetry import LiveMetricsMixin, MetricsRegistry, trace_span
from ..utils import DistributedTimer, Logger, PhaseTimer
from .hooks import Hook


class Runner(LiveMetricsMixin):
    def __init__(
        self,
        model: PipelineModel,
        parameter_server: ParameterServer,
        worker_manager: WorkerManager,
        max_epochs: int,
        max_iters: int,
        loss_cfg: Optional[Dict] = None,
        timer_cfg: Optional[Dict] = None,
        logging_cfg: Optional[Dict] = None,
        seed: int = 0,
        preflight: bool = True,
    ):
        self.model = model
        self.parameter_server = parameter_server
        self.worker_manager = worker_manager
        self._hooks: List[Hook] = []
        self._epoch = 0
        self._iter = 0
        self._inner_iter = 0
        self._max_epochs = max_epochs
        self._max_iters = max_iters
        self._stop = False
        self._generator = torch.Generator().manual_seed(seed)
        # pre-flight plan verification against the first real batch,
        # before the first train step (SKYTPU_PREFLIGHT=0 opts out)
        self._preflight_enabled = preflight
        self._preflight_done = False
        #: the reports of this runner's pre-flight checks, in order
        self.preflight_reports: List = []
        self._logger = Logger(**(logging_cfg or {}))
        self._timer = DistributedTimer(**(timer_cfg or {}))
        self.phase_timer = PhaseTimer()
        # one snapshot() over the pipeline's per-step counters (the
        # callable form survives the model rebinding `stats` every step)
        self.metrics = MetricsRegistry()
        self.metrics.register(
            "pipeline", lambda: self.model.stats.snapshot(),
            types=getattr(type(getattr(self.model, "stats", None)),
                          "FIELD_TYPES", None),
        )
        self.timeseries = None
        self.data_loader = None
        # the in-flight (data, labels) pair, for hooks that need a batch
        self.current_batch = None
        self.aborted = False
        # one metrics dict per EvalHook evaluation, in order
        self.eval_history: List[Dict] = []
        if loss_cfg is not None:
            # the model already owns a loss; loss_cfg overrides it
            self.model.set_loss_fn(build_loss(loss_cfg))

    # --- state --------------------------------------------------------------
    @property
    def hooks(self) -> List[Hook]:
        return self._hooks

    @property
    def epoch(self) -> int:
        return self._epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self._epoch = value

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, value: int) -> None:
        self._iter = value

    @property
    def inner_iter(self) -> int:
        return self._inner_iter

    @property
    def max_epochs(self) -> int:
        return self._max_epochs

    @property
    def max_iters(self) -> int:
        return self._max_iters

    @property
    def timer(self) -> DistributedTimer:
        return self._timer

    @property
    def logger(self) -> Logger:
        return self._logger

    def snapshot_rng(self) -> torch.Tensor:
        """The step-generator stream's state, for checkpointing."""
        return self._generator.get_state()

    def restore_rng(self, state: torch.Tensor) -> None:
        self._generator.set_state(state)

    def request_stop(self) -> None:
        """Cooperative stop: finishes the current iteration then exits."""
        self._stop = True

    # --- pre-flight ---------------------------------------------------------
    def rearm_preflight(self) -> None:
        """Re-run plan verification before the next train step: called
        after anything that changes the plan mid-run (``SelfHealHook``'s
        rebuild), so the new allocation is verified like the first."""
        self._preflight_done = False

    def _preflight(self, data) -> None:
        """Verify the plan against ``data`` once, before a train step.

        A malformed allocation — a stage boundary that does not
        type-check, an over-budget slice, a backward that cannot hand a
        cotangent across — is rejected here with a precise diagnostic.
        """
        if self._preflight_done:
            return
        if not self._preflight_enabled or \
                os.environ.get("SKYTPU_PREFLIGHT", "1") == "0":
            self._preflight_done = True
            return
        if not has_plan(self.model):
            self._logger.info(
                f"pre-flight: skipped — "
                f"{type(self.model).__name__} exposes no allocation"
            )
            self._preflight_done = True
            return
        with trace_span("preflight", "runner", "lifecycle"):
            report = verify_pipeline(self.model, data)
        self.preflight_reports.append(report)
        for issue in report.issues:
            self._logger.info(f"pre-flight: {issue.format()}")
        # done only on success: a rejected plan is re-verified on a
        # retried train(), also when the caller fixed it without going
        # through rearm_preflight
        report.raise_if_failed()
        self._preflight_done = True
        self._logger.info(f"pre-flight: {report.summary()}")

    # --- live observability (LiveMetricsMixin provides the wiring) ----------
    def _health_snapshot(self) -> Dict:
        return dict(
            status="aborted" if getattr(self, "aborted", False) else "ok",
            epoch=self._epoch,
            iter=self._iter,
            max_iters=self._max_iters,
        )

    # --- hooks --------------------------------------------------------------
    def register_hook(self, hook: Hook) -> None:
        if not isinstance(hook, Hook):
            raise TypeError(f"{hook!r} is not a Hook")
        self._hooks.append(hook)

    def _call_hook(self, fn_name: str) -> None:
        for hook in self._hooks:
            getattr(hook, fn_name)(self)

    # --- training -----------------------------------------------------------
    def train(self, data_loader) -> None:
        self.data_loader = data_loader
        self.model.train(True)
        self.aborted = False
        self._call_hook("before_run")
        try:
            self._train_loop(data_loader)
        except Exception:
            # a training error marks the live weights suspect for the
            # hooks' after_run; a KeyboardInterrupt does not
            self.aborted = True
            raise
        finally:
            self._call_hook("after_run")

    def _train_loop(self, data_loader) -> None:
        while self._epoch < self._max_epochs and not self._stop:
            self._call_hook("before_train_epoch")
            self._inner_iter = 0
            exhausted = True

            for data, labels in data_loader:
                if self._iter >= self._max_iters or self._stop:
                    exhausted = False
                    break

                self._logger.info(f"epoch: {self._epoch}, iter: {self._iter}")
                self.current_batch = (data, labels)
                self._preflight(data)
                self._call_hook("before_train_iter")

                step_generator = torch.Generator().manual_seed(
                    int(torch.randint(0, 2 ** 62, (1,),
                                      generator=self._generator))
                )
                self._timer.add_timestamp()
                loss = self.model.train_step(data, labels,
                                             generator=step_generator)
                self._timer.add_timestamp()

                stats = self.model.stats
                self.phase_timer.record("forward", stats.forward_s)
                self.phase_timer.record("backward", stats.backward_s)
                self.phase_timer.record("step", stats.step_s)
                self.phase_timer.record("dispatch", stats.dispatch_s)
                self._logger.info(
                    f"loss: {loss:.6f} | forward time: "
                    f"{stats.forward_s:.4f} | backward time: "
                    f"{stats.backward_s:.4f} | step time: "
                    f"{stats.step_s:.4f} | dispatch: {stats.dispatch_s:.4f}"
                )

                self._iter += 1
                self._inner_iter += 1
                if self.timeseries is not None:
                    self.timeseries.sample()
                self._call_hook("after_train_iter")

            if not exhausted:
                # max_iters / stop interrupted the epoch mid-stream: it did
                # not complete, so it is not counted and after_train_epoch
                # does not fire
                break
            self._epoch += 1
            self._call_hook("after_train_epoch")
            if self._iter >= self._max_iters:
                break

    # --- evaluation ----------------------------------------------------------
    def evaluate(self, data_loader, max_batches: Optional[int] = None,
                 task: Optional[str] = None) -> Dict:
        """Mean loss and accuracy over ``data_loader`` (at most
        ``max_batches`` batches) with the pipeline's eval-mode forward,
        under the ``*_val_*`` hook lifecycle; train mode is restored
        afterwards.  The loss is weighted per example, so a ragged final
        batch counts no more than a full one.  Classification logits
        ``[B, C]`` are scored against their labels; token logits
        ``[B, L, V]`` against the next token.  ``task`` adds the GLUE
        task's own metrics (``ops/metrics.py``: F1 for mrpc, Matthews
        for cola, ...) over all predictions.  The logits come to the host
        once per batch; the loss is computed there."""
        if task is not None:
            from ..ops.metrics import TASK_METRICS

            if task.lower() not in TASK_METRICS:
                raise ValueError(
                    f"unknown task {task!r}; known: {sorted(TASK_METRICS)}")

        self.model.train(False)
        self._call_hook("before_val_epoch")
        loss_sum = 0.0
        correct = num_predictions = num_examples = 0
        all_preds: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        try:
            for i, (data, labels) in enumerate(data_loader):
                if max_batches is not None and i >= max_batches:
                    break
                self._call_hook("before_val_iter")
                with torch.no_grad():
                    logits = self.model.forward(data).to("cpu")
                labels = np.asarray(labels)
                n = len(labels)
                loss_sum += float(self.model._loss_fn(
                    logits, torch.from_numpy(labels))) * n
                preds = logits.float().argmax(dim=-1).numpy()
                if logits.dim() == 3:
                    if task is not None:
                        raise ValueError(
                            "task metrics need per-example classification "
                            "logits; got token-level logits "
                            f"{tuple(logits.shape)}")
                    # the logit at position t predicts token t + 1
                    targets = labels[:, 1:]
                    correct += int((preds[:, :-1] == targets).sum())
                    num_predictions += targets.size
                else:
                    correct += int((preds == labels).sum())
                    num_predictions += n
                    if task is not None:
                        all_preds.append(preds)
                        all_labels.append(labels)
                num_examples += n
                self._call_hook("after_val_iter")
            self._call_hook("after_val_epoch")
        finally:
            self.model.train(True)
        result = {
            "loss": loss_sum / num_examples if num_examples else float("nan"),
            "accuracy": (correct / num_predictions if num_predictions
                         else float("nan")),
            "num_examples": num_examples,
        }
        if all_preds:
            from ..ops.metrics import compute_task_metrics

            task_metrics = compute_task_metrics(
                task, np.concatenate(all_preds), np.concatenate(all_labels))
            result.update({k: v for k, v in task_metrics.items()
                           if k not in result})
        return result


__all__ = ["Runner"]
