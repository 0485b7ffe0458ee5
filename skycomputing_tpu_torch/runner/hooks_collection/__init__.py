"""The hooks the launcher's configs name (the port of
``skycomputing_tpu/runner/hooks_collection``: stop, timer, checkpoint,
evaluation, metrics, NaN guard and watchdog; self-heal, heartbeat,
trace and autotune are later slices)."""

from .checkpoint_hook import CheckpointHook
from .eval_hook import EvalHook
from .metrics_hook import MetricsHook
from .stop_hook import StopHook
from .timer_hook import DistributedTimerHelperHook
from .watchdog_hook import NanGuardHook, WatchdogHook

__all__ = ["CheckpointHook", "DistributedTimerHelperHook", "EvalHook",
           "MetricsHook", "NanGuardHook", "StopHook", "WatchdogHook"]
