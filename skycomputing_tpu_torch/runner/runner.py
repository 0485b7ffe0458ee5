"""The training loop (the port of ``skycomputing_tpu/runner/runner.py``).

An epoch/iteration loop over a dataloader of ``(data, labels)`` pairs
with hook dispatch and per-phase wall-clock records: each iteration is
one ``PipelineModel.train_step`` under a step generator drawn from the
runner's own ``torch.Generator`` (seeded with ``seed``), so seeded runs
replay exactly.  ``max_iters`` and :meth:`Runner.request_stop` end the
run after the current iteration; an epoch cut short is neither counted
nor announced to ``after_train_epoch``.

Not ported yet: pre-flight plan checking (``preflight=True`` raises
``NotImplementedError``), the live-metrics surface and evaluation.  The
JAX runner's compile cache has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..dynamics import ParameterServer, WorkerManager
from ..ops import build_loss
from ..parallel import PipelineModel
from ..utils import DistributedTimer, Logger, PhaseTimer
from .hooks import Hook


class Runner:
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
        preflight: bool = False,
    ):
        if preflight:
            raise NotImplementedError(
                "pre-flight plan checking is not ported to PyTorch yet (a "
                "later slice, over analysis/plan_check.py); pass "
                "preflight=False"
            )
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
        self._logger = Logger(**(logging_cfg or {}))
        self._timer = DistributedTimer(**(timer_cfg or {}))
        self.phase_timer = PhaseTimer()
        self.data_loader = None
        # the in-flight (data, labels) pair, for hooks that need a batch
        self.current_batch = None
        self.aborted = False
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


__all__ = ["Runner"]
