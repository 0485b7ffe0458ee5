"""The port's multi-process glue (``parallel/multihost.py``) against the
contracts of ``tests/test_multihost.py``: no world without a coordinator,
a mesh's shape and its ``needs N devices`` refusal, rank 0 as the
coordinator, and a REAL two-process ``torch.distributed`` world under
gloo on the CPU whose global reduction crosses the process boundary
(2 processes x 2 positions, sum 120), each position's owner known to
every process.  Without a card and without ``device="cpu"`` the glue
refuses to start a world rather than fall back to gloo."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from skycomputing_tpu_torch.parallel import (
    global_mesh,
    initialize_from_env,
    is_coordinator,
)

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(port: int, nprocs: int, pid: int) -> dict:
    """The environment of one process of a local gloo world: the port
    on the path, one thread, a short process-group timeout."""
    env = dict(os.environ)
    env.update(SKYTPU_COORDINATOR=f"127.0.0.1:{port}",
               SKYTPU_NUM_PROCESSES=str(nprocs), SKYTPU_PROCESS_ID=str(pid),
               SKYTPU_PEER_TIMEOUT_S="20", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def run_world(script: str, nprocs: int = 2, timeout: float = 90.0):
    """``script`` in ``nprocs`` processes of one world; (rc, out, err)
    of each, every process killed at the end."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=world_env(port, nprocs, pid),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for pid in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_initialize_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("SKYTPU_COORDINATOR", raising=False)
    assert initialize_from_env() is False  # single-process: no-op


def test_global_mesh_shapes():
    mesh = global_mesh(("dp", "pp"), (2, 4), devices=[CPU] * 8)
    assert dict(mesh.shape) == {"dp": 2, "pp": 4}
    assert mesh.owners.shape == (2, 4) and not mesh.owners.any()
    with pytest.raises(ValueError, match="needs 16 devices"):
        global_mesh(("dp", "pp"), (4, 4), devices=[CPU] * 8)


def test_is_coordinator_single_process():
    assert is_coordinator() is True


def test_initialize_without_a_card_refuses_to_fall_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: NCCL would start")
    monkeypatch.setenv("SKYTPU_COORDINATOR", f"127.0.0.1:{free_port()}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_from_env(num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()


_WORKER = textwrap.dedent(
    """
    import numpy as np
    import torch
    import torch.distributed as dist

    from skycomputing_tpu_torch.parallel import (
        global_mesh, initialize_from_env, is_coordinator,
    )

    cpu = torch.device("cpu")
    assert initialize_from_env(device="cpu") is True  # the true path
    assert initialize_from_env(device="cpu") is True  # a repeat: no-op
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    rank = dist.get_rank()

    mesh = global_mesh(("dp",), (4,), devices=[cpu, cpu])  # 2 x 2
    assert mesh.owners.tolist() == [0, 0, 1, 1], mesh.owners
    data = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    # each process sums the rows of the positions it owns
    local = torch.zeros(())
    for pos in range(mesh.size):
        if mesh.owners[pos] == rank:
            local = local + data[pos].to(mesh.devices[pos]).sum()
    total = local.reshape(1).clone()
    dist.all_reduce(total)
    assert float(total) == 120.0, float(total)
    if is_coordinator():
        assert rank == 0
        print("MULTIHOST_OK", flush=True)
    dist.destroy_process_group()
    """
)


def test_two_process_world_runs_global_reduction():
    outs = run_world(_WORKER)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err}"
    assert [("MULTIHOST_OK" in out) for _, out, _ in outs] == [True, False]
