"""Timer hygiene (the port of
``skycomputing_tpu/runner/hooks_collection/timer_hook.py``): the
runner's timestamp list starts and ends each run empty."""

from __future__ import annotations

from ...registry import HOOKS
from ..hooks import Hook


@HOOKS.register_module
class DistributedTimerHelperHook(Hook):
    def before_run(self, runner):
        runner.timer.clean()

    def after_run(self, runner):
        runner.timer.clean()


__all__ = ["DistributedTimerHelperHook"]
