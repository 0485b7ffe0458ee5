"""Layer -> worker allocation (the port of
``skycomputing_tpu/dynamics/allocator.py``).

Ported: ``even_allocate`` — floor division of the layer list over the
worker pool with the remainder spread over the first workers, no
profiling — and ``_apply_partition``, which writes given layer ranges
and pipeline orders onto the workers and re-ranks them.  The
profile-driven strategies (optimal and dynamic allocation), the
measured-time calibrations and ``refine_allocation`` need the
benchmarkers and the solver, which slice 4 ports; here they raise
``NotImplementedError``.  Serving and mesh allocation are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from ..utils import Logger
from .worker_manager import WorkerManager


def _not_ported(method: str):
    raise NotImplementedError(
        f"Allocator.{method} is not ported to PyTorch yet (slice 4: the "
        f"benchmarkers, the solver and profile-driven allocation)"
    )


class Allocator:
    def __init__(
        self,
        model_cfg: List[Dict],
        worker_manager: WorkerManager,
        model_benchmarker: Any = None,
        device_benchmarker: Any = None,
        logger: Optional[Logger] = None,
    ):
        self._model_cfg = model_cfg
        self._worker_manager = worker_manager
        # kept for the profile-driven strategies of slice 4; even
        # allocation never reads them
        self._model_benchmarker = model_benchmarker
        self._device_benchmarker = device_benchmarker
        self._logger = logger or Logger()

    @property
    def model_config(self) -> List[Dict]:
        """The per-layer config list this allocator partitions."""
        return self._model_cfg

    def _apply_partition(
        self,
        worker_ranks: List[int],
        ranges: List[Optional[Tuple[int, int]]],
        orders: List[int],
    ) -> WorkerManager:
        """Write layer slices + pipeline order onto workers, then re-rank."""
        for rank, rng, order in zip(worker_ranks, ranges, orders):
            worker = self._worker_manager.get_by_rank(rank)
            if rng is None:
                worker.model_config = []
            else:
                worker.model_config = self._model_cfg[rng[0]: rng[1]]
            worker.order = order
            self._logger.info(
                f"worker rank {rank}: layers {rng}, pipeline order {order}"
            )
        self._worker_manager.reset_rank_by_order()
        return self._worker_manager

    def even_allocate(self) -> WorkerManager:
        """Pure arithmetic split, no profiling."""
        pool = self._worker_manager.worker_pool
        num_worker = len(pool)
        num_layer = len(self._model_cfg)
        avg = math.floor(num_layer / num_worker)
        remainder = num_layer - avg * num_worker

        cursor = 0
        for idx, worker in enumerate(pool):
            take = avg + (1 if idx < remainder else 0)
            worker.model_config = self._model_cfg[cursor: cursor + take]
            worker.order = idx + 1
            cursor += take
        return self._worker_manager

    # --- slice 4 ------------------------------------------------------------
    def optimal_allocate(self, max_time: float = 300, threads: int = 24):
        _not_ported("optimal_allocate")

    def dynamic_allocate(self, break_iter: int = 1000):
        _not_ported("dynamic_allocate")

    def refine_allocation(self, measured_stage_times, damping: float = 0.5,
                          max_time: float = 300, attribute: str = "layers"):
        _not_ported("refine_allocation")

    def calibrate_costs(self, stage_layer_counts, measured_stage_times,
                        damping: float = 1.0):
        _not_ported("calibrate_costs")

    def calibrate_costs_affine(self, stage_layer_counts,
                               measured_stage_times):
        _not_ported("calibrate_costs_affine")

    def calibrate_costs_by_type(self, stage_layer_counts,
                                measured_stage_times):
        _not_ported("calibrate_costs_by_type")

    def calibrate_device_speeds(self, measured_stage_times,
                                damping: float = 1.0):
        _not_ported("calibrate_device_speeds")


__all__ = ["Allocator"]
