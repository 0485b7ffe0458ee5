"""Periodic evaluation (the port of
``skycomputing_tpu/runner/hooks_collection/eval_hook.py``)."""

from __future__ import annotations

from typing import Optional

from ...registry import HOOKS
from ..hooks import Hook


@HOOKS.register_module
class EvalHook(Hook):
    """Runs ``runner.evaluate`` on a held-out loader every ``interval``
    epochs; each result, with its ``epoch``, is appended to
    ``runner.eval_history`` and logged."""

    def __init__(self, data_loader, interval: int = 1,
                 max_batches: Optional[int] = None):
        self._data_loader = data_loader
        self._interval = interval
        self._max_batches = max_batches

    def after_epoch(self, runner):
        # evaluate() fires only the val lifecycle, which the Hook base
        # does not route to after_epoch, so this cannot re-enter
        if not self.every_n_epochs(runner, self._interval):
            return
        metrics = runner.evaluate(self._data_loader,
                                  max_batches=self._max_batches)
        metrics["epoch"] = runner.epoch
        runner.eval_history.append(metrics)
        runner.logger.info(
            f"eval @ epoch {runner.epoch}: loss={metrics['loss']:.4f} "
            f"accuracy={metrics['accuracy']:.4f} "
            f"({metrics['num_examples']} examples)"
        )


__all__ = ["EvalHook"]
