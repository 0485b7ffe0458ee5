"""Per-step kernel launches in the run's log (the port's own hook: the
JAX package compiles its kernels into one program per stage and has no
launches to count).  Before each training iteration it reads the flash
kernel's launch counts by body (``ops.flash_attention``), after it
logs the launches the step made, as ``kernel launches: flash_attention
{"tensor_core": 24}``; a step that launched none logs nothing (the
CPU's plain versions count no launch).  The launcher config registers
it under ``SKYTPU_KERNEL_LAUNCHES=1``, which ``tools/run_ladder`` sets
for its rungs and whose lines it reads back."""

from __future__ import annotations

import json
from typing import Dict

from ...registry import HOOKS
from ..hooks import Hook


def _flash_bodies() -> Dict[str, int]:
    from ...ops.flash_attention import flash_attention

    return dict(flash_attention.body_launches)


@HOOKS.register_module
class KernelLaunchHook(Hook):
    def __init__(self):
        self._before: Dict[str, int] = {}

    def before_train_iter(self, runner):
        self._before = _flash_bodies()

    def after_train_iter(self, runner):
        step = {body: n - self._before.get(body, 0)
                for body, n in _flash_bodies().items()
                if n != self._before.get(body, 0)}
        if step:
            runner.logger.info(
                f"kernel launches: flash_attention {json.dumps(step)}")
