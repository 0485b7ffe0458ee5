"""The training loop, its hook base and the hook collection (the port of
``skycomputing_tpu/runner``)."""

from .hooks import Hook
from .hooks_collection import (
    AutotuneHook,
    CheckpointHook,
    DistributedTimerHelperHook,
    EvalHook,
    HeartbeatHook,
    MetricsHook,
    NanGuardHook,
    SelfHealHook,
    StopHook,
    TraceHook,
    WatchdogHook,
)
from .runner import Runner

__all__ = ["AutotuneHook", "CheckpointHook", "DistributedTimerHelperHook", "EvalHook",
           "HeartbeatHook", "Hook", "MetricsHook", "NanGuardHook", "Runner", "SelfHealHook",
           "StopHook", "TraceHook", "WatchdogHook"]
