"""Failure detection hooks (the port of
``skycomputing_tpu/runner/hooks_collection/watchdog_hook.py``).

- ``NanGuardHook``: stop (or raise) the moment the loss of an iteration
  (``runner.model.stats.loss``) is not finite.
- ``WatchdogHook``: flag iterations over a wall-clock budget (a wedged
  device or a stuck copy surfaces as a slow step), after
  ``grace_iters`` warm-up iterations; ``action="stop"`` also stops.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ...registry import HOOKS
from ..hooks import Hook


@HOOKS.register_module
class NanGuardHook(Hook):
    def __init__(self, action: str = "stop"):
        if action not in ("stop", "raise"):
            raise ValueError(f"unknown action {action!r}")
        self._action = action

    def after_iter(self, runner):
        loss = runner.model.stats.loss
        if math.isfinite(loss):
            return
        message = f"non-finite loss {loss} at iter {runner.iter}"
        runner.logger.info(f"NanGuardHook: {message}")
        if self._action == "raise":
            raise FloatingPointError(message)
        runner.request_stop()


@HOOKS.register_module
class WatchdogHook(Hook):
    def __init__(self, max_iter_seconds: float, action: str = "log",
                 grace_iters: int = 1):
        if action not in ("log", "stop"):
            raise ValueError(f"unknown action {action!r}")
        self._budget = max_iter_seconds
        self._action = action
        # first iterations pay the warm-up (allocator, library handles)
        self._grace_iters = grace_iters
        self._started: Optional[float] = None

    def before_iter(self, runner):
        self._started = time.perf_counter()

    def after_iter(self, runner):
        if self._started is None:
            return
        elapsed = time.perf_counter() - self._started
        if elapsed <= self._budget or runner.iter <= self._grace_iters:
            return
        runner.logger.info(
            f"WatchdogHook: iter {runner.iter - 1} took {elapsed:.2f}s "
            f"(budget {self._budget}s)"
        )
        if self._action == "stop":
            runner.request_stop()


__all__ = ["NanGuardHook", "WatchdogHook"]
