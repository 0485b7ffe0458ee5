"""The hooks the launcher's configs name (the port of
``skycomputing_tpu/runner/hooks_collection``: stop, timer, checkpoint,
evaluation, metrics, NaN guard, watchdog, trace, self-heal, heartbeat
and autotune), and the port's own per-step kernel-launch log."""

from .autotune_hook import AutotuneHook
from .checkpoint_hook import CheckpointHook
from .eval_hook import EvalHook
from .heartbeat_hook import HeartbeatHook
from .kernel_launch_hook import KernelLaunchHook
from .metrics_hook import MetricsHook
from .selfheal_hook import SelfHealHook
from .stop_hook import StopHook
from .timer_hook import DistributedTimerHelperHook
from .trace_hook import TraceHook
from .watchdog_hook import NanGuardHook, WatchdogHook

__all__ = ["AutotuneHook", "CheckpointHook", "DistributedTimerHelperHook", "EvalHook",
           "HeartbeatHook", "KernelLaunchHook", "MetricsHook", "NanGuardHook", "SelfHealHook", "StopHook",
           "TraceHook", "WatchdogHook"]
