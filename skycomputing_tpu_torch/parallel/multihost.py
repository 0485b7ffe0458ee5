"""Multi-process scale-out (the port of
``skycomputing_tpu/parallel/multihost.py``).

JAX joins a world of processes through ``jax.distributed.initialize``
and its coordination service; the port joins a ``torch.distributed``
process group instead: ``init_process_group`` over
``tcp://<coordinator>``, NCCL on the card, gloo where the caller asks
for the CPU.  The configuration is the same environment the JAX glue
reads (and :class:`~.elastic.ElasticSupervisor` exports), so a
scheduler's launcher drives either package.

A dead peer surfaces as a collective that raises or never completes.
JAX's counterpart of how long that may take is the coordination
service's heartbeat timeout; here it is the process group's
``timeout``, read from ``SKYTPU_PEER_TIMEOUT_S`` (seconds) when set.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device, resolve_devices
from .mesh import Mesh

#: seconds a collective may wait on a peer before the process group
#: raises (exported by the elastic supervisor)
PEER_TIMEOUT_ENV = "SKYTPU_PEER_TIMEOUT_S"


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join (or skip) the multi-process world based on env/args.

    Reads ``SKYTPU_COORDINATOR`` (host:port), ``SKYTPU_NUM_PROCESSES``,
    ``SKYTPU_PROCESS_ID`` — falling back to the Slurm variables the
    reference used (``SLURM_NPROCS`` / ``SLURM_PROCID``).  Returns True
    when a process group is up (a repeat call is a no-op), False for
    the single-process case (no coordinator configured).

    The backend is NCCL, each process on card ``process_id % cards``
    (or on ``device``), and raises where there is no card; gloo only
    when ``device`` is the CPU.
    """
    coordinator_address = coordinator_address or os.getenv(
        "SKYTPU_COORDINATOR"
    )
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True

    num_processes = num_processes if num_processes is not None else int(
        os.getenv("SKYTPU_NUM_PROCESSES", os.getenv("SLURM_NPROCS", "1"))
    )
    process_id = process_id if process_id is not None else int(
        os.getenv("SKYTPU_PROCESS_ID", os.getenv("SLURM_PROCID", "0"))
    )
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        dev = resolve_device(device)
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    kwargs = {}
    timeout_s = os.getenv(PEER_TIMEOUT_ENV)
    if timeout_s:
        kwargs["timeout"] = timedelta(seconds=float(timeout_s))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        **kwargs,
    )
    return True


def collective_device() -> torch.device:
    """Where the process group's collectives take their tensors: the
    CPU under gloo, this process's card under NCCL."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int],
                devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over every process's positions, in rank order.

    Each process contributes ``devices`` (default: every CUDA device,
    raising without one); the mesh's ``owners`` say which rank drives
    each position.  Axis order is (outer..inner): put the
    communication-heavy axis last so its collectives stay within a
    process's devices and only the outer axes cross processes.
    """
    local = [str(d) for d in resolve_devices(devices)]
    if dist.is_initialized() and dist.get_world_size() > 1:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local)
    else:
        gathered = [local]
    flat = [(rank, torch.device(d))
            for rank, devs in enumerate(gathered) for d in devs]
    want = int(np.prod(axis_sizes))
    if len(flat) < want:
        raise ValueError(
            f"mesh {dict(zip(axis_names, axis_sizes))} needs {want} "
            f"devices, world has {len(flat)}"
        )
    shape = tuple(int(s) for s in axis_sizes)
    grid = np.empty(want, dtype=object)
    grid[:] = [d for _, d in flat[:want]]
    owners = np.array([r for r, _ in flat[:want]], dtype=np.int64)
    return Mesh(grid.reshape(shape), tuple(axis_names),
                owners=owners.reshape(shape))


def is_coordinator() -> bool:
    """True on the process that should write checkpoints and logs: rank
    0, or the only process when no group is up."""
    return not dist.is_initialized() or dist.get_rank() == 0


__all__ = ["PEER_TIMEOUT_ENV", "collective_device", "global_mesh",
           "initialize_from_env", "is_coordinator"]
