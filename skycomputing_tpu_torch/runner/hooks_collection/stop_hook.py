"""Out-of-band cooperative stop (the port of
``skycomputing_tpu/runner/hooks_collection/stop_hook.py``): after each
iteration, poll a stop-flag file that another process may write, and
ask the runner to stop after the current iteration."""

from __future__ import annotations

import os
import os.path as osp

from ...registry import HOOKS
from ..hooks import Hook

STOP_FILENAME = "stop_flag.txt"


@HOOKS.register_module
class StopHook(Hook):
    def __init__(self, root: str):
        self._root = root
        os.makedirs(root, exist_ok=True)

    @property
    def _flag_path(self) -> str:
        return osp.join(self._root, STOP_FILENAME)

    def before_run(self, runner):
        # a stale flag from an earlier run must not stop this one
        if osp.exists(self._flag_path):
            os.remove(self._flag_path)

    def after_iter(self, runner):
        if osp.exists(self._flag_path):
            with open(self._flag_path) as fh:
                if fh.read().strip() == "1":
                    runner.logger.info("stop flag detected — stopping run")
                    runner.request_stop()

    @staticmethod
    def stop(root: str) -> None:
        """Ask a running trainer whose StopHook watches ``root`` to stop."""
        with open(osp.join(root, STOP_FILENAME), "w") as fh:
            fh.write("1")


__all__ = ["StopHook"]
