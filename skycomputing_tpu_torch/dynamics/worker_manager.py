"""Cluster-membership registry (the port's own copy of
``skycomputing_tpu/dynamics/worker_manager.py``; stdlib only).

One controller process owns every device, so rank 0 is not reserved for
a host process by default and every worker can hold layers;
``reserve_host_rank=True`` gives the 1-host + N-worker numbering.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .worker import Worker


def worker_pool_config(num_workers: int, mem_limit: float = -1,
                       prefix: str = "gpu") -> List[Dict]:
    """Configs of ``num_workers`` pipeline workers, worker ``i`` on card
    ``i`` (round-robined over the cards there are), no slowdown, and a
    memory limit in MB (``-1``: the card's free memory)."""
    return [
        dict(name=f"{prefix}-{i}", device_config=dict(device_index=i),
             extra_config=dict(slowdown=1.0, mem_limit=mem_limit))
        for i in range(num_workers)
    ]


class WorkerManager:
    def __init__(self, reserve_host_rank: bool = False):
        self._worker_pool: List[Worker] = []
        self._first_rank = 1 if reserve_host_rank else 0

    @property
    def size(self) -> int:
        return len(self._worker_pool)

    @property
    def worker_pool(self) -> List[Worker]:
        return self._worker_pool

    def get_by_id(self, id_str: str, allow_not_found: bool = False) -> Optional[Worker]:
        for worker in self._worker_pool:
            if worker.id == id_str:
                return worker
        if allow_not_found:
            return None
        raise LookupError(f"Worker with id {id_str} is not found in the worker pool")

    def get_by_rank(self, rank: int) -> Worker:
        for worker in self._worker_pool:
            if worker.rank == rank:
                return worker
        raise LookupError(f"Worker with rank {rank} is not found in the worker pool")

    def load_worker_pool_from_config(self, config: List[Dict]) -> None:
        for i, worker_config in enumerate(config):
            worker = Worker(rank=self._first_rank + i, **worker_config)
            self._worker_pool.append(worker)

    def assign_model_to_worker(self, rank: int, model_config: List[Dict]) -> None:
        self.get_by_rank(rank).model_config = model_config

    def add_worker(self, worker_id: str, worker_config: Dict) -> None:
        rank = self._first_rank + len(self._worker_pool)
        self._worker_pool.append(
            Worker(rank=rank, worker_id=worker_id, **worker_config)
        )

    def remove_worker_by_id(self, id_str: str) -> None:
        worker = self.get_by_id(id_str)
        if worker.is_running:
            # a real error, not an assert: under ``python -O`` asserts
            # vanish and a running worker would be silently dropped from
            # the pool while its stage still executes
            raise RuntimeError(
                f"Worker {id_str} is still running; stop it before "
                f"removing it from the pool"
            )
        self._worker_pool.remove(worker)
        self._allocate_rank()

    def _allocate_rank(self) -> None:
        for i, worker in enumerate(self._worker_pool):
            worker.rank = self._first_rank + i

    def reset_rank_by_order(self) -> None:
        """Re-sort the pool by pipeline order and re-rank so rank == stage."""
        self._worker_pool.sort(key=lambda w: w.order)
        self._allocate_rank()

    def serialize(self) -> List[Dict]:
        return [w.serialize() for w in self._worker_pool]

    @staticmethod
    def deserialize(data: List[Dict]) -> "WorkerManager":
        manager = WorkerManager()
        for worker_data in data:
            manager.worker_pool.append(Worker.deserialize(worker_data))
        return manager


__all__ = ["WorkerManager", "worker_pool_config"]
