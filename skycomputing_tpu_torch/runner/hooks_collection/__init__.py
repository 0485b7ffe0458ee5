"""The hooks the launcher's configs name (the port of
``skycomputing_tpu/runner/hooks_collection``: stop, timer and
checkpoint; eval, metrics, watchdog, self-heal, trace and autotune are
later slices)."""

from .checkpoint_hook import CheckpointHook
from .stop_hook import StopHook
from .timer_hook import DistributedTimerHelperHook

__all__ = ["CheckpointHook", "DistributedTimerHelperHook", "StopHook"]
