"""The training loop, its hook base and the hook collection (the port of
``skycomputing_tpu/runner``)."""

from .hooks import Hook
from .hooks_collection import (
    CheckpointHook,
    DistributedTimerHelperHook,
    EvalHook,
    MetricsHook,
    NanGuardHook,
    StopHook,
    WatchdogHook,
)
from .runner import Runner

__all__ = ["CheckpointHook", "DistributedTimerHelperHook", "EvalHook",
           "Hook", "MetricsHook", "NanGuardHook", "Runner", "StopHook",
           "WatchdogHook"]
