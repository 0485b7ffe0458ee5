"""Seeded heterogeneity injector (the port's own copy of
``skycomputing_tpu/stimulator``; numpy only).

Per-worker random slowdown factors for memory, network and compute,
applied multiplicatively to device-benchmark results so that workers on
one card behave like the paper's geo-distributed cluster.  Each draw is
``(hi - lo) * default_rng(seed).random(worker_num + 1) + lo``, so the
same seeds give the JAX package's factors bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Stimulator:
    def __init__(
        self,
        worker_num: int,
        memory_range: Tuple[float, float] = (1.0, 3.0),
        network_range: Tuple[float, float] = (1.0, 2.0),
        compute_range: Tuple[float, float] = (1.0, 4.0),
        memory_seed: int = 22,
        network_seed: int = 32,
        compute_seed: int = 42,
    ):
        self.worker_num = worker_num

        def draw(rng_seed, lo, hi):
            rng = np.random.default_rng(seed=rng_seed)
            return (hi - lo) * rng.random((worker_num + 1,)) + lo

        self.m_slowdown = draw(memory_seed, *memory_range)
        self.n_slowdown = draw(network_seed, *network_range)
        self.c_slowdown = draw(compute_seed, *compute_range)

    def memory_slowdown(self, worker_id: int) -> float:
        return float(self.m_slowdown[worker_id])

    def compute_slowdown(self, worker_id: int) -> float:
        return float(self.c_slowdown[worker_id])

    def network_stimulate(self, worker_id: int) -> float:
        return float(self.n_slowdown[worker_id])


__all__ = ["Stimulator"]
