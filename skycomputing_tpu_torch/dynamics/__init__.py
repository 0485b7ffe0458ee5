"""Cluster membership, profiling, allocation, the host parameter store
and seeded fault injection (the port of ``skycomputing_tpu/dynamics``)."""

from .allocator import Allocator
from .benchmarker import (
    DeviceBenchmarker,
    ModelBenchmarker,
    device_available_memory_mb,
    proxy_device_benchmarker,
)
from .estimator import Estimator
from .parameter_server import ParameterServer
from .solver import PartitionResult, solve_contiguous_minmax
from .worker import Worker
from .worker_manager import WorkerManager, worker_pool_config

# last: faults imports the runner's Hook, whose package imports the names
# above
from .faults import FaultInjectionHook, FaultPlan  # noqa: E402

__all__ = [
    "Allocator",
    "DeviceBenchmarker",
    "Estimator",
    "FaultInjectionHook",
    "FaultPlan",
    "ModelBenchmarker",
    "ParameterServer",
    "PartitionResult",
    "Worker",
    "WorkerManager",
    "device_available_memory_mb",
    "proxy_device_benchmarker",
    "solve_contiguous_minmax",
    "worker_pool_config",
]
