"""Shared construction of the headline-benchmark instance (the port's
own copy of ``skycomputing_tpu/dynamics/headline.py``), and the
headline pass itself (:func:`headline_pass`, ``bench.py``'s even ->
calibrate -> optimal pass over measured stage times).

The paper's headline pass is: per-worker compute slowdowns
(:func:`worker_slowdowns`), a per-worker memory budget divided by the
Stimulator's seeded skew, the contiguous min-max solve, and the step
time of per-stage times under the pipeline schedule
(:func:`schedule_step_time`).  ``regime="reference"`` is the reference
experiment's loose memory world (a flat 16 GiB raw budget per worker,
emulating its ``mem_limit=-1`` free-memory probe on 16 GB-class nodes:
compute binds); ``regime="tight"`` gives total capacity 1.5x the model
footprint, a memory-starved stress world.

Run the pass ``N`` times at BERT-large's width on the card (one JSON
line per pass, then a count of the passes where optimal beat even)::

    python -m skycomputing_tpu_torch.dynamics.headline --passes 8 \
        [--layers 24] [--device cpu --preset tiny --layers 2]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..dataset import RandomTokenGenerator
from ..models import bert_config, bert_layer_configs
from ..ops import cross_entropy_loss
from ..parallel.pipeline import PipelineModel, sgd
from ..stimulator import Stimulator
from .allocator import Allocator
from .benchmarker import ModelBenchmarker, proxy_device_benchmarker
from .parameter_server import ParameterServer
from .solver import PartitionResult, solve_contiguous_minmax
from .worker_manager import WorkerManager, worker_pool_config

# Flat per-worker raw memory budget emulating the reference's mem_limit=-1
# free-memory probe on its 16 GB-class GPU nodes (see module docstring).
REFERENCE_WORKER_MEM_MB = 16 * 1024.0

# the microbatch counts the headline pass scores each allocation at
HEADLINE_MICROBATCHES = (4, 16)


def worker_slowdowns(n_workers: int, kind: str = "paper") -> np.ndarray:
    """Per-worker compute slowdown factors.

    ``paper``: the reference experiment's own heterogeneity generator —
    reproducible integers in [1, 7), seed 35
    (the reference's ``experiment/config.py:67-71``).  ``stimulator``: the
    seeded Stimulator compute draw.
    """
    if kind == "paper":
        rng = np.random.default_rng(seed=35)
        return rng.integers(low=1, high=7, size=n_workers + 1).astype(
            np.float64
        )[1:]
    if kind == "stimulator":
        return np.asarray(Stimulator(n_workers).c_slowdown[:n_workers])
    raise ValueError(f"unknown slowdown kind {kind!r}")


def memory_skew(n_workers: int) -> np.ndarray:
    """The Stimulator's seeded per-worker memory skew (capacity divisor)."""
    return np.asarray(Stimulator(n_workers).m_slowdown[:n_workers])


def worker_mem_budget_mb(
    layer_mem: Sequence[float],
    n_workers: int,
    regime: str = "reference",
) -> float:
    """Raw per-worker memory budget in MB (before the skew divisor).

    ``reference``: flat 16 GiB — the reference's ``mem_limit=-1`` probe
    regime (loose; compute binds).  ``tight``: total capacity = 1.5x the
    model footprint (a memory-starved stress regime).
    """
    if regime == "reference":
        return REFERENCE_WORKER_MEM_MB
    if regime == "tight":
        skew = memory_skew(n_workers)
        return 1.5 * float(np.sum(layer_mem)) / float(np.sum(1.0 / skew))
    raise ValueError(f"unknown memory regime {regime!r}")


def schedule_step_time(
    taus: Sequence[float], num_microbatches: int, sequential: bool = False
) -> float:
    """Step time of per-stage times under the engine's schedule.

    GPipe fill-drain: ``sum(tau)/M + (M-1)/M * max(tau)``; sequential is
    the reference's non-microbatched semantics (one batch traverses the
    stages in order, the reference's ``scaelum/model/rpc_model.py:49-55``).
    """
    taus = np.asarray(taus, dtype=np.float64)
    if sequential:
        return float(taus.sum())
    M = num_microbatches
    return float(taus.sum() / M + (M - 1) / M * taus.max())


def even_partition(n_layers: int, n_workers: int) -> List[int]:
    """Reference even split: floor division + remainder spread
    (the reference's ``scaelum/dynamics/allocator.py:259-293``)."""
    base, rem = divmod(n_layers, n_workers)
    counts = [base + (1 if i < rem else 0) for i in range(n_workers)]
    idx = [0]
    for c in counts:
        idx.append(idx[-1] + c)
    return idx


def evaluate_instance(
    layer_flops: Sequence[float],
    layer_mem: Sequence[float],
    slowdowns: np.ndarray,
    num_microbatches: Optional[int] = None,
    regime: str = "reference",
    mem_budget_mb: Optional[float] = None,
    sequential: bool = False,
    tolerance: float = 1e-6,
) -> Dict:
    """Allocator + schedule math for the headline instance.

    Models per-stage time as ``slowdown_d * sum(flops of the slice)`` —
    the same proportionality ``bench.py`` realises with measured wall
    times — and returns even/optimal step times, speedup, and the solver
    result with its certified lower bound.
    """
    n_workers = len(slowdowns)
    layer_flops = list(layer_flops)
    layer_mem = list(layer_mem)
    L = len(layer_flops)
    if num_microbatches is None:
        num_microbatches = 2 * n_workers
    if mem_budget_mb is None:
        mem_budget_mb = worker_mem_budget_mb(layer_mem, n_workers, regime)
    skew = memory_skew(n_workers)
    dev_mem = mem_budget_mb / skew

    result: PartitionResult = solve_contiguous_minmax(
        layer_cost=layer_flops,
        layer_mem=layer_mem,
        device_time=list(slowdowns),
        device_mem=list(dev_mem),
        tolerance=tolerance,
    )
    flops_prefix = np.concatenate([[0.0], np.cumsum(layer_flops)])
    tau_opt = [
        float(slowdowns[d]) * float(flops_prefix[e] - flops_prefix[s])
        for d, (s, e) in zip(result.device_order, result.slices)
    ]

    idx = even_partition(L, n_workers)
    tau_even = [
        float(slowdowns[i])
        * float(flops_prefix[idx[i + 1]] - flops_prefix[idx[i]])
        for i in range(n_workers)
    ]

    t_even = schedule_step_time(tau_even, num_microbatches, sequential)
    t_opt = schedule_step_time(tau_opt, num_microbatches, sequential)
    return dict(
        step_time_even=t_even,
        step_time_optimal=t_opt,
        speedup_pct=(t_even - t_opt) / t_even * 100.0,
        solver_result=result,
        tau_even=tau_even,
        tau_optimal=tau_opt,
        mem_budget_mb=float(mem_budget_mb),
    )


class PaperSkew:
    """The stimulator's interface over fixed per-worker compute
    slowdowns and memory skews (``bench.py``'s ``ProfileSkew``)."""

    def __init__(self, slowdowns: Sequence[float], skew: Sequence[float]):
        self._slowdowns = [float(s) for s in slowdowns]
        self._skew = [float(s) for s in skew]

    def compute_slowdown(self, index: int) -> float:
        return self._slowdowns[index]

    def memory_slowdown(self, index: int) -> float:
        return self._skew[index]


def headline_pass(
    model_cfg: List[Dict],
    model_bench: ModelBenchmarker,
    data,
    slowdowns: Sequence[float],
    static_costs: Sequence[float],
    devices: Optional[Sequence] = None,
    repeats: int = 10,
    log: Optional[Callable[[str], None]] = None,
) -> Dict:
    """The headline pass as ``bench.py`` runs it, one worker per entry of
    ``slowdowns`` on ``devices`` (the cards when None).  A stage's raw
    time is measured on its device (``measure_stage_times`` over
    ``data``, the median of ``repeats`` samples of 3 chained
    iterations) and multiplied by its worker's slowdown; the step time
    is :func:`schedule_step_time` at each of ``HEADLINE_MICROBATCHES``.

    1. ``even_allocate``, then the stage times;
    2. ``calibrate_costs_by_group`` from the even pass: one scale for the
       repeated stack, one for the units before it and one for those
       after (``bench.py``'s per-type fit is underdetermined at a few
       stages: BERT has 6 unit types);
    3. ``optimal_allocate`` over ``model_bench``'s profile (memory: the
       reference regime's budget divided by the stimulator's skew), then
       the stage times, twice;
    4. the even allocation once more: ``bench.py``'s drift bracket, made
       symmetric (even, optimal, optimal, even).  Each side's step is
       the mean of its two, so a steady drift of the host during the
       pass lands on both sides alike.

    Beside it, what the static model predicts from ``static_costs``
    (per-unit FLOPs; :func:`evaluate_instance`).  ``log`` takes a line
    per measurement.  Returns the partitions, raw and emulated stage times,
    the step times and speedup per microbatch count, the fitted group
    scales and the solver's result."""
    log = log or (lambda line: None)
    slowdowns = np.asarray(slowdowns, dtype=np.float64)
    n_workers = len(slowdowns)
    skew = memory_skew(n_workers)
    _, layer_mem = model_bench.benchmark()
    budget = worker_mem_budget_mb(layer_mem, n_workers, "reference")
    predicted = {}
    for m in HEADLINE_MICROBATCHES:
        model = evaluate_instance(static_costs, layer_mem, slowdowns, m)
        solved = model["solver_result"]
        ranges = solved.as_ranges(n_workers)
        predicted[m] = dict(
            speedup=model["speedup_pct"] / 100,
            partition=[ranges[d][1] - ranges[d][0]
                       for d in solved.device_order])
    log(f"the static model predicts: {json.dumps(predicted)}")
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(0))

    def pool():
        wm = WorkerManager()
        wm.load_worker_pool_from_config(
            worker_pool_config(n_workers, mem_limit=budget, prefix="node"))
        return wm

    def measure(label, wm):
        stages = sorted((w for w in wm.worker_pool if w.model_config),
                        key=lambda w: w.rank)
        model = PipelineModel(wm, ps, sgd(1e-3), cross_entropy_loss,
                              devices=devices)
        t0 = time.perf_counter()
        raw = model.measure_stage_times(data, repeats=repeats,
                                        inner_iters=3)
        pass_s = time.perf_counter() - t0
        del model
        stage_slow = [float(slowdowns[w.stim_index]) for w in stages]
        taus = [t * s for t, s in zip(raw, stage_slow)]
        out = dict(partition=[len(w.model_config) for w in stages],
                   slowdowns=stage_slow, raw_stage_s=raw,
                   emulated_stage_s=taus, pass_s=pass_s,
                   step_s={m: schedule_step_time(taus, m)
                           for m in HEADLINE_MICROBATCHES})
        log(f"{label}: {json.dumps(out)}")
        return out

    even_wm = pool()
    Allocator(model_cfg, even_wm).even_allocate()
    even = measure("even", even_wm)
    wm = pool()
    allocator = Allocator(model_cfg, wm, model_bench, proxy_device_benchmarker(
        wm, devices=devices, stimulator=PaperSkew(slowdowns, skew)))
    scales = allocator.calibrate_costs_by_group(even["partition"],
                                                even["raw_stage_s"])
    log(f"group scales from the even pass: {json.dumps(scales)}")
    t0 = time.perf_counter()
    allocator.optimal_allocate(max_time=30)
    solve_s = time.perf_counter() - t0
    solved = allocator.last_result
    optimal = measure("optimal", wm)
    optimal_again = measure("optimal, again", wm)
    even_again = measure("even, again", even_wm)

    def mean_step(a, b):
        return {m: (a["step_s"][m] + b["step_s"][m]) / 2
                for m in HEADLINE_MICROBATCHES}

    even_step = mean_step(even, even_again)
    optimal_step = mean_step(optimal, optimal_again)
    return dict(
        even=even, even_again=even_again, even_step_s=even_step,
        optimal=optimal, optimal_again=optimal_again,
        optimal_step_s=optimal_step, predicted=predicted,
        group_scales=scales, solver_gap=solved.optimality_gap,
        solver_path=solved.path, solve_s=solve_s,
        speedup={m: (even_step[m] - optimal_step[m]) / even_step[m]
                 for m in HEADLINE_MICROBATCHES},
        worker_slowdowns=slowdowns.tolist(),
        memory_budget_mb=[budget / s for s in skew])


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="the headline pass, repeated, under the paper's "
                    "slowdowns")
    parser.add_argument("--passes", type=int, default=1)
    parser.add_argument("--preset", default="large")
    parser.add_argument("--layers", type=int, default=24)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--device",
                        help="run every stage here (e.g. cpu) instead of "
                             "on the cards")
    args = parser.parse_args(argv)
    devices = None if args.device is None else [torch.device(args.device)]
    cfg = bert_config(args.preset, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=args.layers,
                                   num_classes=3, deterministic=True)
    # the reference benchmark's batch: no padding, token types 0
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.vocab_size,
                       size=(args.batch, args.seq)).astype(np.int32)
    data = (ids, np.zeros_like(ids), np.ones_like(ids))

    def tokens():
        return RandomTokenGenerator(args.batch, args.seq, cfg.vocab_size)

    static = ModelBenchmarker(model_cfg, tokens())
    timed = ModelBenchmarker(model_cfg, tokens(), timed=True,
                             device=None if devices is None else devices[0])
    slowdowns = worker_slowdowns(4, "paper")
    wins = {}
    for i in range(args.passes):
        out = headline_pass(model_cfg, timed, data, slowdowns,
                            static.benchmark()[0], devices=devices,
                            repeats=args.repeats)
        for m, step in out["optimal_step_s"].items():
            wins[m] = wins.get(m, 0) + int(step < out["even_step_s"][m])
        print(json.dumps(dict(pass_index=i, **out), default=str), flush=True)
    print(json.dumps(dict(passes=args.passes, optimal_below_even=wins)))
    return 0


__all__ = [
    "HEADLINE_MICROBATCHES",
    "PaperSkew",
    "REFERENCE_WORKER_MEM_MB",
    "headline_pass",
    "worker_slowdowns",
    "memory_skew",
    "worker_mem_budget_mb",
    "schedule_step_time",
    "even_partition",
    "evaluate_instance",
]


if __name__ == "__main__":
    sys.exit(main())
