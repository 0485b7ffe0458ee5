"""Layer -> worker allocation strategies (the port of
``skycomputing_tpu/dynamics/allocator.py``).

Three strategies over joint device and model profiles, each writing a
worker's layer slice into ``worker.model_config``, setting its pipeline
``order`` and re-ranking the pool so that rank equals stage order:

- ``optimal_allocate``: minimize ``max_d device_time[d] * sum(layer
  costs of d's slice)`` under per-device memory and contiguity, by the
  contiguous min-max solver (:mod:`.solver`);
- ``dynamic_allocate``: even split, then memory repair, then iterative
  cost x time balancing;
- ``even_allocate``: floor division with the remainder spread.

The closed loop folds measured stage times back into the model:
``calibrate_costs`` (per-slice rescale), ``calibrate_costs_affine``,
``calibrate_costs_by_type`` (one cost per distinct unit config),
``calibrate_costs_by_group`` (one scale per group of units: the port's
own, well posed at a few stages), ``calibrate_device_speeds`` (the gap
attributed to devices) and ``refine_allocation`` (a calibration, then
a re-solve).  ``serving_allocate`` solves over a decode-step profile.
Mesh allocation is a later slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import trace_span
from ..utils import Logger
from .solver import solve_contiguous_minmax
from .worker_manager import WorkerManager


def unit_groups(model_cfg: List[Dict]) -> List[str]:
    """A group label per unit for :meth:`Allocator.calibrate_costs_by_group`:
    ``"stack"`` for a unit whose config occurs more than once (an
    encoder layer's thirds), ``"first"`` for a unique unit before the
    first of those and ``"last"`` for one after the last; a unique unit
    between them, or in a model with no repeated unit, is its own
    group."""
    keys = [json.dumps(cfg, sort_keys=True, default=str) for cfg in model_cfg]
    repeated = [i for i, k in enumerate(keys) if keys.count(k) > 1]
    labels = []
    for i, key in enumerate(keys):
        if keys.count(key) > 1:
            labels.append("stack")
        elif repeated and i < repeated[0]:
            labels.append("first")
        elif repeated and i > repeated[-1]:
            labels.append("last")
        else:
            labels.append(key)
    return labels


def _nonnegative_fit(A: np.ndarray, measured) -> np.ndarray:
    """Least squares ``A @ x ≈ measured`` with ``x >= 0``: negative
    solutions are clamped to zero and the rest refit (active set).  A
    zero would make its columns free to the solver (degenerate
    packing), so clamped entries are floored at 5% of the median
    positive one."""
    y = np.asarray(measured, dtype=np.float64)
    active = list(range(A.shape[1]))
    c = np.zeros(A.shape[1])
    for _ in range(A.shape[1] + 1):
        if not active:
            break
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        neg = [k for k, v in zip(active, sol) if v < 0.0]
        for k, v in zip(active, sol):
            c[k] = max(v, 0.0)
        if not neg:
            break
        active = [k for k in active if k not in neg]
    positive = [v for v in c if v > 0.0]
    if positive:
        floor = 0.05 * float(np.median(positive))
        c = np.maximum(c, floor)
    return c


def _not_ported(method: str, slice_name: str):
    raise NotImplementedError(
        f"Allocator.{method} is not ported to PyTorch yet (a later slice: "
        f"{slice_name})"
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
        self._model_benchmarker = model_benchmarker
        self._device_benchmarker = device_benchmarker
        self._logger = logger or Logger()
        self._cost_override: Optional[List[float]] = None
        # worker.id -> multiplicative device-speed correction, learned from
        # live training telemetry (calibrate_device_speeds).  Keyed by the
        # worker's stable id, not rank: allocation re-ranks the pool.
        self._speed_override: Dict[str, float] = {}

    # ------------------------------------------------------------------ util
    @property
    def model_config(self) -> List[Dict]:
        """The per-layer config list this allocator partitions."""
        return self._model_cfg

    def snapshot_calibration(self) -> Dict[str, object]:
        """Everything :meth:`restore_calibration` needs to undo learned
        corrections: the per-layer cost override and the per-device
        speed override.  A rolled-back tuning proposal must revert BOTH
        the partition and the calibration that produced it — otherwise
        the next solve re-derives the same rejected plan from the
        poisoned model."""
        return {
            "cost": (
                list(self._cost_override)
                if self._cost_override is not None else None
            ),
            "speed": dict(self._speed_override),
        }

    def restore_calibration(self, snapshot: Dict[str, object]) -> None:
        cost = snapshot["cost"]
        self._cost_override = list(cost) if cost is not None else None
        self._speed_override = dict(snapshot["speed"])

    def _profiles(self):
        device_results = self._device_benchmarker.benchmark()
        layer_flops, layer_mem = self._model_benchmarker.benchmark()
        if self._cost_override is not None:
            layer_flops = list(self._cost_override)

        worker_ranks = [
            int(name.lstrip("worker")) for name in device_results.keys()
        ]
        perf = list(device_results.values())
        device_time = [p["time"] for p in perf]
        device_mem = [p["avai_mem"] for p in perf]
        if self._speed_override:
            device_time = [
                t * self._speed_override.get(
                    self._worker_manager.get_by_rank(r).id, 1.0
                )
                for r, t in zip(worker_ranks, device_time)
            ]
        return worker_ranks, device_time, device_mem, layer_flops, layer_mem

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
                worker.model_config = self._model_cfg[rng[0] : rng[1]]
            worker.order = order
            self._logger.info(
                f"worker rank {rank}: layers {rng}, pipeline order {order}"
            )
        self._worker_manager.reset_rank_by_order()
        return self._worker_manager

    # --------------------------------------------------------------- optimal
    def optimal_allocate(self, max_time: float = 300) -> WorkerManager:
        """MIP-equivalent bottleneck-optimal allocation.

        ``max_time`` bounds the solver's anneal wall clock, matching the
        reference's MIP time limit semantics
        (``scaelum/dynamics/allocator.py:109-132`` gives CBC 300 s); on a
        slow host the binary-search + local-search solution is returned
        once the budget is spent, with whatever certified gap it reached.
        """
        with trace_span("allocator.profiles", "dynamics", "allocator"):
            (worker_ranks, device_time, device_mem, layer_flops,
             layer_mem) = self._profiles()
        self._logger.info(
            f"optimal_allocate: {len(layer_flops)} layers over "
            f"{len(worker_ranks)} workers; device_time={device_time}"
        )

        with trace_span(
            "allocator.solve", "dynamics", "allocator",
            {"layers": len(layer_flops), "workers": len(worker_ranks)},
        ):
            result = solve_contiguous_minmax(
                layer_cost=layer_flops,
                layer_mem=layer_mem,
                device_time=device_time,
                device_mem=device_mem,
                anneal_seconds=max_time,
            )
        # exposed for callers that report provenance (the certified
        # optimality gap, the solver's path)
        self.last_result = result
        self._logger.info(
            f"optimal bottleneck: {result.bottleneck:.4g} "
            f"(certified lower bound {result.lower_bound:.4g}, gap "
            f"{result.optimality_gap:.4f}, device order "
            f"{result.device_order}, solver path {result.path})"
        )

        ranges = result.as_ranges(len(worker_ranks))
        # Pipeline order: devices in slice order first, empty devices after.
        orders = [0] * len(worker_ranks)
        pos = 1
        for d in result.device_order:
            orders[d] = pos
            pos += 1
        for d in range(len(worker_ranks)):
            if ranges[d] is None:
                orders[d] = pos
                pos += 1
        return self._apply_partition(worker_ranks, ranges, orders)

    # --------------------------------------------------------------- serving
    def serving_allocate(self, decode_benchmarker,
                         max_time: float = 300) -> WorkerManager:
        """Bottleneck-optimal partition for DECODE-step serving load: the
        solver of :meth:`optimal_allocate` over another profile.
        ``decode_benchmarker`` (a
        :class:`~..serving.profile.DecodeModelBenchmarker`) supplies one
        decode iteration's FLOPs as cost and parameters plus KV memory
        as memory, so each stage's slabs or pages must fit its
        ``mem_limit``.

        A training-calibrated cost override (:meth:`calibrate_costs` and
        its kin) is set aside for the solve, since it was learned at
        training granularity, and restored after it, with the training
        profiler.  The device-speed override stays: a slow node is slow
        for any workload."""
        saved_bench = self._model_benchmarker
        saved_override = self._cost_override
        self._model_benchmarker = decode_benchmarker
        self._cost_override = None
        try:
            return self.optimal_allocate(max_time=max_time)
        finally:
            self._model_benchmarker = saved_bench
            self._cost_override = saved_override

    # ----------------------------------------------------- closed-loop refine
    def calibrate_costs(
        self, stage_layer_counts, measured_stage_times,
        damping: float = 1.0,
    ) -> None:
        """Rescale the per-layer cost model from ANY allocation's measured
        stage times — without re-solving.

        ``stage_layer_counts``/``measured_stage_times``: pipeline-order
        slice lengths and raw per-stage seconds of the allocation that was
        measured (need not be this allocator's current one).  The classic
        use is seeding the *first* optimal solve from the even baseline's
        measurement, which the headline pass takes anyway: isolated
        per-unit profiles miss slice-level fusion/cache effects, while the
        even pass measures every layer at deployment granularity for free.
        ``refine_allocation`` is this plus a re-solve, with the counts
        read from the allocator's own current allocation.
        """
        base_costs, _ = self._model_benchmarker.benchmark()
        costs = list(
            self._cost_override
            if self._cost_override is not None
            else base_costs
        )
        if len(stage_layer_counts) != len(measured_stage_times):
            raise ValueError(
                f"{len(measured_stage_times)} measured times for "
                f"{len(stage_layer_counts)} stages"
            )
        pos = 0
        for n, t in zip(stage_layer_counts, measured_stage_times):
            pred = sum(costs[pos:pos + n])
            if pred > 0 and t > 0:
                scale = (float(t) / pred) ** float(damping)
                costs[pos:pos + n] = [c * scale for c in costs[pos:pos + n]]
            pos += n
        if pos != len(costs):
            raise ValueError(
                f"stage slices cover {pos} layers, model has {len(costs)}"
            )
        self._cost_override = costs

    def calibrate_costs_affine(
        self, stage_layer_counts, measured_stage_times
    ) -> Tuple[float, float]:
        """Fit a slice-size-aware cost model from measured stage times.

        The per-slice uniform rescale of :meth:`calibrate_costs` learns
        scales *at the measured allocation's granularity* — scales taken
        from an even split (3-4 units/stage) transfer poorly to the
        solver's output (1-10 units/stage), so the first optimal solve
        lands far from the measurement-refined answer.

        This fits the two-parameter model

            t_stage  ≈  a * sum(unit_costs in slice)  +  b * |slice|

        by least squares over the measured stages: ``a`` scales the
        profiled per-unit compute, ``b`` absorbs the per-unit overhead
        (dispatch, layer-boundary materialization, cache effects) that an
        isolated per-unit profile cannot see.  Both terms are additive per
        layer, so the calibrated instance stays inside the contiguous
        min-max solver's cost model: ``cost'_i = a * cost_i + b``.
        Negative fits are clamped to the best one-parameter model.

        Returns ``(a, b)`` for provenance.
        """
        base_costs, _ = self._model_benchmarker.benchmark()
        costs = list(base_costs)
        if len(stage_layer_counts) != len(measured_stage_times):
            raise ValueError(
                f"{len(measured_stage_times)} measured times for "
                f"{len(stage_layer_counts)} stages"
            )
        if sum(stage_layer_counts) != len(costs):
            raise ValueError(
                f"stage slices cover {sum(stage_layer_counts)} layers, "
                f"model has {len(costs)}"
            )
        sums, ns = [], []
        pos = 0
        for n in stage_layer_counts:
            sums.append(sum(costs[pos:pos + n]))
            ns.append(float(n))
            pos += n
        X = np.stack([np.asarray(sums), np.asarray(ns)], axis=1)
        y = np.asarray(measured_stage_times, dtype=np.float64)
        a = b = -1.0
        if len(y) >= 2:
            sol, *_ = np.linalg.lstsq(X, y, rcond=None)
            a, b = float(sol[0]), float(sol[1])
        if a < 0.0 or b < 0.0 or len(y) < 2:
            # degenerate (collinear features / tiny sample): fall back to
            # whichever single-term model explains the data better
            s, n = X[:, 0], X[:, 1]
            a_only = float(np.dot(y, s) / max(np.dot(s, s), 1e-30))
            b_only = float(np.dot(y, n) / max(np.dot(n, n), 1e-30))
            if (np.sum((y - a_only * s) ** 2)
                    <= np.sum((y - b_only * n) ** 2)):
                a, b = max(a_only, 0.0), 0.0
            else:
                a, b = 0.0, max(b_only, 0.0)
        self._cost_override = [a * c + b for c in costs]
        return a, b

    def calibrate_costs_by_type(
        self, stage_layer_counts, measured_stage_times
    ):
        """Fit one cost per distinct UNIT TYPE from measured stage times.

        The affine fit (:meth:`calibrate_costs_affine`) keeps the noisy
        single-draw timed per-unit profile in its feature (``sum of unit
        costs``), so its parameters — especially the per-unit overhead
        term — swing run to run and the solver's allocation swings with
        them.  Deep stacked models have only a handful of distinct unit
        configs (the program cache dedups on exactly this), so the
        measured stages give a small well-posed regression

            t_stage  ≈  sum_type  count(stage, type) * c_type

        whose ONLY stochastic input is the stage-time medians — the
        per-unit profile drops out of the solve entirely.  Negative
        solutions are clamped to zero and the remainder refit
        (active-set) so the override stays a valid additive cost model.

        Returns ``{type_json: cost}`` for provenance.
        """
        if len(stage_layer_counts) != len(measured_stage_times):
            raise ValueError(
                f"{len(measured_stage_times)} measured times for "
                f"{len(stage_layer_counts)} stages"
            )
        if sum(stage_layer_counts) != len(self._model_cfg):
            raise ValueError(
                f"stage slices cover {sum(stage_layer_counts)} layers, "
                f"model has {len(self._model_cfg)}"
            )
        type_of = [
            json.dumps(cfg, sort_keys=True, default=str)
            for cfg in self._model_cfg
        ]
        types = sorted(set(type_of))
        tindex = {t: i for i, t in enumerate(types)}
        A = np.zeros((len(stage_layer_counts), len(types)))
        pos = 0
        for j, n in enumerate(stage_layer_counts):
            for i in range(pos, pos + n):
                A[j, tindex[type_of[i]]] += 1.0
            pos += n
        c = _nonnegative_fit(A, measured_stage_times)
        self._cost_override = [float(c[tindex[t]]) for t in type_of]
        return {t: float(c[tindex[t]]) for t in types}

    def calibrate_costs_by_group(
        self, stage_layer_counts, measured_stage_times
    ) -> Dict[str, float]:
        """Fit one scale per GROUP of units from measured stage times
        (the port's own; the JAX package has no counterpart).

        At a few stages :meth:`calibrate_costs_by_type` is
        underdetermined: BERT-large has 6 unit types and 4 stages, and
        the three thirds of an encoder layer are nearly collinear over
        contiguous slices (each slice holds about as many of each), so
        that fit trades cost between them on the noise of one unit.
        Here units are grouped by :func:`unit_groups` (the repeated
        stack, the unique units before it and those after it) and each
        group's profiled costs are scaled by one factor:

            t_stage  ≈  sum_group a_group * sum(profiled costs of the
                        group's units in the stage)

        which leaves BERT 3 unknowns for 4 stages.  The profile sets the
        proportions inside a group (where in an encoder layer a boundary
        falls costs the most), the stage times set each group's scale.
        Clamped and floored as :meth:`calibrate_costs_by_type`.

        Returns ``{group: scale}`` for provenance.
        """
        base_costs, _ = self._model_benchmarker.benchmark()
        if len(stage_layer_counts) != len(measured_stage_times):
            raise ValueError(
                f"{len(measured_stage_times)} measured times for "
                f"{len(stage_layer_counts)} stages"
            )
        if sum(stage_layer_counts) != len(base_costs):
            raise ValueError(
                f"stage slices cover {sum(stage_layer_counts)} layers, "
                f"model has {len(base_costs)}"
            )
        groups = unit_groups(self._model_cfg)
        names = sorted(set(groups))
        gindex = {g: i for i, g in enumerate(names)}
        A = np.zeros((len(stage_layer_counts), len(names)))
        pos = 0
        for j, n in enumerate(stage_layer_counts):
            for i in range(pos, pos + n):
                A[j, gindex[groups[i]]] += float(base_costs[i])
            pos += n
        a = _nonnegative_fit(A, measured_stage_times)
        self._cost_override = [
            float(a[gindex[g]]) * float(c) for g, c in zip(groups, base_costs)
        ]
        return {g: float(a[gindex[g]]) for g in names}

    # ------------------------------------------- device-speed calibration
    def _ordered_stage_workers(self, measured_stage_times) -> List:
        """Non-empty workers in pipeline order, validated against the
        measurement list length."""
        workers = sorted(
            (w for w in self._worker_manager.worker_pool if w.model_config),
            key=lambda w: w.order,
        )
        if len(workers) != len(measured_stage_times):
            raise ValueError(
                f"{len(measured_stage_times)} measured times for "
                f"{len(workers)} non-empty stages"
            )
        return workers

    def stage_divergence(self, measured_stage_times) -> Dict[int, float]:
        """Per-worker measured/modeled stage-time ratio, median-normalized.

        For each non-empty stage (pipeline order), the cost model predicts
        ``device_time[worker] * sum(layer costs in slice)``; the ratio of
        the MEASURED stage time to that prediction, divided by the median
        ratio across stages (which absorbs the model's arbitrary global
        units), isolates per-DEVICE anomalies: a healthy calibrated world
        reads ~1.0 everywhere, a 3x-degraded node reads ~3.0.  Keyed by
        the worker's stable ``stim_index`` so the figure survives
        re-ranking and process restarts (worker uuids don't).
        """
        workers = self._ordered_stage_workers(measured_stage_times)
        worker_ranks, device_time, _, layer_flops, _ = self._profiles()
        dt = dict(zip(worker_ranks, device_time))
        raw: Dict[int, float] = {}
        pos = 0
        for w, t in zip(workers, measured_stage_times):
            n = len(w.model_config)
            pred = dt[w.rank] * sum(layer_flops[pos:pos + n])
            raw[w.stim_index] = float(t) / pred if pred > 0 and t > 0 else 1.0
            pos += n
        if pos != len(layer_flops):
            raise ValueError(
                f"stage slices cover {pos} layers, model has "
                f"{len(layer_flops)}"
            )
        ratios = sorted(raw.values())
        mid = len(ratios) // 2
        median = (
            ratios[mid]
            if len(ratios) % 2
            else 0.5 * (ratios[mid - 1] + ratios[mid])
        )
        if median <= 0:
            return {k: 1.0 for k in raw}
        return {k: v / median for k, v in raw.items()}

    def calibrate_device_speeds(
        self, measured_stage_times, damping: float = 1.0
    ) -> Dict[int, float]:
        """Fold measured per-stage divergence into the DEVICE model.

        ``calibrate_costs`` attributes measured/predicted gaps to the
        LAYERS of each slice — right for slice-size effects (fusion,
        cache), wrong for a degraded node: rescaled layers stay expensive
        wherever the re-solve moves them, so the solver never routes work
        AWAY from the slow device.  This pass attributes the gap to the
        DEVICE instead (multiplying its modeled time by the normalized
        divergence), which is exactly the straggler model.  Multiplicative
        and keyed by stable worker id, so repeated calibrations converge:
        once the override matches reality the divergence reads 1.0.

        Returns the stim_index-keyed divergence ratios for provenance.
        """
        ratios = self.stage_divergence(measured_stage_times)
        for w in self._worker_manager.worker_pool:
            if w.stim_index in ratios:
                scale = ratios[w.stim_index] ** float(damping)
                self._speed_override[w.id] = (
                    self._speed_override.get(w.id, 1.0) * scale
                )
        return ratios

    def device_scales(self) -> Dict[int, float]:
        """The CUMULATIVE device-speed override, keyed by stable
        ``stim_index`` — the serializable form of everything this
        allocator has learned about node degradation.  This (not a single
        round's divergence) is what must cross a process boundary: a
        relaunched trainer starts with a fresh override, so staging only
        the latest measurement would silently drop every earlier
        correction."""
        return {
            w.stim_index: self._speed_override[w.id]
            for w in self._worker_manager.worker_pool
            if w.id in self._speed_override
        }

    def apply_device_scales(self, scales: Dict) -> None:
        """Seed the device-speed override from a serialized map
        (``{stim_index: scale}``, int or str keys — JSON round-trips
        stringify them).  This is how a re-formed elastic world carries a
        self-heal measurement across the process boundary: the exiting
        trainer stages the scales through the rendezvous payload and the
        relaunched trainer applies them before its first allocation."""
        by_index = {int(k): float(v) for k, v in scales.items()}
        for w in self._worker_manager.worker_pool:
            if w.stim_index in by_index:
                self._speed_override[w.id] = (
                    self._speed_override.get(w.id, 1.0)
                    * by_index[w.stim_index]
                )

    def refine_allocation(
        self, measured_stage_times, damping: float = 0.5,
        max_time: float = 300, attribute: str = "layers",
    ) -> WorkerManager:
        """Re-allocate with per-layer costs calibrated to MEASURED stage
        times — closed-loop allocation.

        Per-layer profiles (static FLOPs or isolated timed units) cannot
        see slice-level effects: cache pressure makes a 10-unit stage cost
        more than 10 x one unit, so the solver underestimates big slices
        and overloads fast devices.  This pass rescales every layer's cost
        by its own stage's measured/predicted ratio (the reference's
        ``dynamic_allocate`` rebalanced iteratively on flops x time for
        the same reason, ``scaelum/dynamics/allocator.py:181-257``; here
        the feedback is real wall time) and re-solves.  Call after
        ``optimal_allocate`` + a measurement pass
        (``PipelineModel.measure_stage_times``); iterate to converge —
        each round's slices change the slice-size effects being modeled.

        ``measured_stage_times`` are raw per-stage seconds, pipeline
        order, one per worker with a non-empty slice.  ``damping``
        exponentiates the per-stage correction (``scale**damping``):
        a full-strength update (1.0) can oscillate between two
        allocations — slice-level scales are applied uniformly to a
        slice's layers, so re-solved boundaries re-mix them — while a
        damped update contracts toward a fixed point.

        ``attribute`` picks where the measured/modeled gap lands:
        ``"layers"`` (default, the historical behavior) rescales the
        slice's layer costs — right for slice-size effects; ``"devices"``
        rescales the owning device's modeled speed
        (:meth:`calibrate_device_speeds`) — right for a degraded node,
        which is the self-healing runtime's case.
        """
        if attribute == "devices":
            # validates the measurement list itself (stage_divergence)
            with trace_span("allocator.calibrate", "dynamics", "allocator",
                            {"attribute": attribute}):
                self.calibrate_device_speeds(measured_stage_times,
                                             damping=damping)
        elif attribute == "layers":
            workers = self._ordered_stage_workers(measured_stage_times)
            with trace_span("allocator.calibrate", "dynamics", "allocator",
                            {"attribute": attribute}):
                self.calibrate_costs(
                    [len(w.model_config) for w in workers],
                    measured_stage_times,
                    damping=damping,
                )
        else:
            raise ValueError(
                f"unknown attribute {attribute!r}; use 'layers' or 'devices'"
            )
        return self.optimal_allocate(max_time=max_time)

    # ------------------------------------------------ later slices
    def mesh_allocate(self, num_devices=None, max_stages=None,
                      max_chips_per_stage=None, stage_overhead: float = 0.0):
        _not_ported("mesh_allocate", "mesh-native stages")

    def refine_mesh_allocation(self, measured_stage_times,
                               damping: float = 0.5, chips=None,
                               **mesh_kwargs):
        _not_ported("refine_mesh_allocation", "mesh-native stages")

    # --------------------------------------------------------------- dynamic
    def dynamic_allocate(self, break_iter: int = 1000) -> WorkerManager:
        """Greedy: even split -> memory repair -> flops x time balancing."""
        (worker_ranks, device_time, device_mem, layer_flops, layer_mem) = (
            self._profiles()
        )

        if min(device_mem) <= min(layer_mem):
            raise RuntimeError(
                "The smallest worker has insufficient memory for the "
                "smallest layer"
            )

        num_layer = len(layer_flops)
        num_worker = len(worker_ranks)
        avg = math.floor(num_layer / num_worker)
        remainder = num_layer - avg * num_worker
        counts = [avg + (1 if i < remainder else 0) for i in range(num_worker)]
        partition_idx = [0]
        for c in counts:
            partition_idx.append(partition_idx[-1] + c)

        partition_idx = self._allocate_by_mem(
            partition_idx, device_mem, layer_mem
        )
        partition_idx = self._allocate_by_flops_time(
            partition_idx, device_time, layer_flops, device_mem, layer_mem,
            break_iter,
        )

        ranges: List[Optional[Tuple[int, int]]] = [
            (partition_idx[i], partition_idx[i + 1]) for i in range(num_worker)
        ]
        orders = list(range(1, num_worker + 1))
        return self._apply_partition(worker_ranks, ranges, orders)

    # ------------------------------------------------------------------ even
    def even_allocate(self) -> WorkerManager:
        """Pure arithmetic split, no profiling (reference :259-293)."""
        pool = self._worker_manager.worker_pool
        num_worker = len(pool)
        num_layer = len(self._model_cfg)
        avg = math.floor(num_layer / num_worker)
        remainder = num_layer - avg * num_worker

        cursor = 0
        for idx, worker in enumerate(pool):
            take = avg + (1 if idx < remainder else 0)
            worker.model_config = self._model_cfg[cursor : cursor + take]
            worker.order = idx + 1
            cursor += take
        return self._worker_manager

    # -------------------------------------------------- greedy repair passes
    @staticmethod
    def _mem_allocated(layer_mem, partition_idx):
        return [
            sum(layer_mem[partition_idx[j] : partition_idx[j + 1]])
            for j in range(len(partition_idx) - 1)
        ]

    def _allocate_by_mem(self, partition_idx, device_mem, layer_mem):
        """Shift slice boundaries until every device fits its slice.

        Reference ``_allocate_by_mem`` (:370-439): walk adjacent pairs,
        move boundary left when over capacity, right when there's headroom.
        """
        num_worker = len(device_mem)
        for _ in range(10 * num_worker * max(len(layer_mem), 1)):
            allocated = self._mem_allocated(layer_mem, partition_idx)
            if all(a <= m for a, m in zip(allocated, device_mem)):
                return partition_idx
            old = list(partition_idx)
            for j in range(num_worker - 1):
                # shrink overfull worker j from the right
                while (
                    self._mem_allocated(layer_mem, partition_idx)[j]
                    > device_mem[j]
                    and partition_idx[j + 1] - partition_idx[j] > 1
                ):
                    partition_idx[j + 1] -= 1
                # grow underfull worker j if the next can spare layers
                while (
                    partition_idx[j + 2] - partition_idx[j + 1] > 1
                    and sum(
                        layer_mem[partition_idx[j] : partition_idx[j + 1] + 1]
                    )
                    < device_mem[j]
                    and self._mem_allocated(layer_mem, partition_idx)[j + 1]
                    > device_mem[j + 1]
                ):
                    partition_idx[j + 1] += 1
            if old == partition_idx:
                break
        allocated = self._mem_allocated(layer_mem, partition_idx)
        if all(a <= m for a, m in zip(allocated, device_mem)):
            return partition_idx
        raise RuntimeError(f"memory allocation failed: {partition_idx}")

    def _allocate_by_flops_time(
        self, partition_idx, device_time, layer_flops, device_mem, layer_mem,
        break_iter,
    ):
        """Iteratively move boundaries toward equal flops x time per worker.

        Reference ``_allocate_by_flops_time`` (:295-368): compare each
        worker's load to the average target; grow cheap workers by one layer
        (memory permitting), shrink expensive ones.
        """
        norm = min(device_time)
        rel_time = [t / norm for t in device_time]
        num_worker = len(device_time)

        def load(j, idx):
            return sum(layer_flops[idx[j] : idx[j + 1]]) * rel_time[j]

        for _ in range(break_iter):
            target = sum(load(j, partition_idx) for j in range(num_worker)) / (
                num_worker
            )
            old = list(partition_idx)
            for j in range(num_worker - 1):
                current = load(j, partition_idx)
                if (
                    current < target
                    and partition_idx[j + 2] - partition_idx[j + 1] > 1
                ):
                    expected_mem = sum(
                        layer_mem[partition_idx[j] : partition_idx[j + 1] + 1]
                    )
                    if expected_mem < device_mem[j]:
                        partition_idx[j + 1] += 1
                else:
                    last_layer_cost = (
                        layer_flops[partition_idx[j + 1] - 1] * rel_time[j]
                    )
                    next_load = load(j + 1, partition_idx)
                    if (
                        next_load < target
                        and current > target + last_layer_cost
                        and partition_idx[j + 1] - partition_idx[j] > 1
                    ):
                        next_expected_mem = sum(
                            layer_mem[
                                partition_idx[j + 1] - 1 : partition_idx[j + 2]
                            ]
                        )
                        if next_expected_mem < device_mem[j + 1]:
                            partition_idx[j + 1] -= 1
            if old == partition_idx:
                break
        return partition_idx


__all__ = ["Allocator"]
