"""Cluster membership, allocation and the host parameter store (the
port of ``skycomputing_tpu/dynamics``: slice 3 ports the workers, even
allocation and the parameter server)."""

from .allocator import Allocator
from .parameter_server import ParameterServer
from .worker import Worker
from .worker_manager import WorkerManager

__all__ = ["Allocator", "ParameterServer", "Worker", "WorkerManager"]
