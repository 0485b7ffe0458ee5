"""The paper's headline benchmark on the port: the step-time improvement
of optimal over even allocation (the port of the repo's ``bench.py``).

The reference's headline is "55% training time improvement" for the
profiled min-max allocation over the even split on a heterogeneous
cluster.  Heterogeneity is injected as the reference injects it on
homogeneous hardware: per-worker compute slowdowns drawn from the
reference experiment's own generator (integers in [1, 7), seed 35) and
the seeded Stimulator's memory skew, applied to the profiles the
allocator sees and to the measured stage times.  The instance is built
by the helpers of :mod:`.dynamics.headline` (``worker_slowdowns``,
``memory_skew``, ``worker_mem_budget_mb``, ``schedule_step_time``,
``evaluate_instance``), so the bench and the headline pass cannot drift.

Method, on the card (or on ``--device``):

1. a timed per-unit profile of the model (forward + backward seconds);
2. ``even_allocate``, then the real pipeline's per-stage forward +
   backward times (``PipelineModel.measure_stage_times``, the median of
   ``REPEATS + 2`` samples);
3. per-unit-type costs regressed from the even pass's stage times
   (``CALIBRATION``: ``types``, or ``affine``, ``scale``, ``0``), then
   ``optimal_allocate`` and its stage times (after one sanity train
   step that must give a finite loss);
4. ``POLISH`` measured-time moves of the bottleneck: each slides one
   unit off the stage whose emulated time is the largest, through a
   chain of stages, to the stage the calibrated costs predict absorbs it
   with the lowest new maximum, never onto a worker it would overfill
   and never back to an allocation already visited; then a fresh
   re-measurement of the best allocation, or, without the time for it,
   the last polish step;
5. the even allocation once more (the drift bracket): the even step is
   the mean of its two measurements;
6. beside it, the speedup at ffn/1 granularity from the static model
   (``evaluate_instance`` on a timed ffn/1 profile).

A stage's emulated time is its measured time times its worker's
slowdown; the step is ``schedule_step_time`` (GPipe with ``MICROBATCHES``
microbatches, or the sum of stage times under ``SEQUENTIAL=1``).  The
metric is ``(even - optimal) / even`` in percent; ``vs_baseline``
divides it by the reference's 55.

Output contract: exactly one JSON line on stdout, the last thing
printed (notes go to stderr)::

    {"metric", "value", "unit": "percent", "vs_baseline", "platform":
     "gpu" | "cpu", "device_kind", "units", "even_partition",
     "optimal_partition", "solver_gap", "refine_steps", "even_steps",
     "polish_moves", "final_remeasure", "calibration", "value_ffn1_model",
     "pass_s", "phases_skipped", "partial", "elapsed_s", "deadline_s"}

``SKYTPU_BENCH_DEADLINE_S`` (1680) is the wall budget counted from the
process's start; the refine, polish, final re-measurement, drift
bracket and ffn/1 phases each run only when the time left affords them
(estimated from the passes already measured), and ``phases_skipped``
names those that did not.  SIGTERM and SIGALRM (armed at the deadline
plus 60 s) print the best result so far with ``partial`` saying why; a
crash prints it too and exits 1.

Knobs (``SKYTPU_BENCH_*``): ``WORKERS`` (64), ``LAYER_NUM`` (53 encoder
layers), ``PRESET`` (large), ``BATCH`` (32; sequence 128),
``MICROBATCHES`` (4 x workers), ``FFN_SHARDS`` (2: each FFN block as two
column-shard units), ``SLOWDOWN`` (paper | stimulator), ``REPEATS`` (4),
``MEM_REGIME`` (reference | tight), ``MEM_MB`` (a raw per-worker budget
in MB instead), ``PROFILE`` (timed | static), ``CALIBRATION`` (types),
``POLISH`` (6), ``REFINE`` (0), ``EVEN_BRACKET`` (1), ``EMIT_FFN1`` (1),
``SOLVER_S`` (adaptive, at most 90), ``SEQUENTIAL`` (0), ``DEADLINE_S``.
The model is BERT with dropouts 0 and flash attention off, as the JAX
bench builds it.  Usage::

    python -m skycomputing_tpu_torch.bench            # on the card
    SKYTPU_BENCH_PRESET=tiny SKYTPU_BENCH_WORKERS=4 \\
        python -m skycomputing_tpu_torch.bench --device cpu

Left out of the port: the JAX bench's accelerator probe ladder, its
watcher log and its CPU fallback (here a box without a card raises
unless ``--device`` names another device); the XLA compile cache and
``SKYTPU_HOTPATH`` (PyTorch runs eagerly); the MFU side artifact
(``tools/bench_mfu.py`` is not ported).  The JAX bench's pre-flight
``verify_plan`` waits for the port of ``analysis/plan_check.py``; until
then :func:`check_partition` refuses, before each pipeline is built, an
allocation that is not a contiguous cover of every unit.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .dataset import RandomTokenGenerator
from .dynamics.allocator import Allocator
from .dynamics.benchmarker import ModelBenchmarker, proxy_device_benchmarker
from .dynamics.headline import (
    PaperSkew,
    evaluate_instance,
    memory_skew,
    schedule_step_time,
    worker_mem_budget_mb,
    worker_slowdowns,
)
from .dynamics.parameter_server import ParameterServer
from .dynamics.worker_manager import WorkerManager
from .models import bert_config, bert_layer_configs
from .ops import cross_entropy_loss
from .parallel.pipeline import PipelineModel, sgd
from .utils import resolve_devices

SEQ_LEN = 128
BASELINE_PCT = 55.0


def _process_start() -> float:
    """The wall-clock time this process started (the module's import
    time where ``psutil`` is missing)."""
    try:
        import psutil

        return psutil.Process().create_time()
    except ImportError:
        return time.time()


@dataclass(frozen=True)
class Knobs:
    """The ``SKYTPU_BENCH_*`` settings, with the JAX bench's defaults."""

    workers: int = 64
    layer_num: int = 53
    preset: str = "large"
    batch: int = 32
    microbatches: Optional[int] = None  # 4 x workers
    ffn_shards: int = 2
    slowdown: str = "paper"
    repeats: int = 4
    mem_regime: str = "reference"
    mem_mb: Optional[float] = None
    profile: str = "timed"
    calibration: str = "types"
    polish: int = 6
    refine: int = 0
    even_bracket: bool = True
    emit_ffn1: bool = True
    solver_s: Optional[float] = None
    sequential: bool = False
    deadline_s: float = 1680.0

    @classmethod
    def from_env(cls, env: Mapping[str, str]) -> "Knobs":
        def get(name, cast, default):
            value = env.get(f"SKYTPU_BENCH_{name}")
            return default if value is None else cast(value)

        workers = get("WORKERS", int, cls.workers)
        return cls(
            workers=workers,
            layer_num=get("LAYER_NUM", int, cls.layer_num),
            preset=get("PRESET", str, cls.preset),
            batch=get("BATCH", int, cls.batch),
            microbatches=get("MICROBATCHES", int, 4 * workers),
            ffn_shards=get("FFN_SHARDS", int, cls.ffn_shards),
            slowdown=get("SLOWDOWN", str, cls.slowdown),
            repeats=get("REPEATS", int, cls.repeats),
            mem_regime=get("MEM_REGIME", str, cls.mem_regime),
            mem_mb=get("MEM_MB", float, None),
            profile=get("PROFILE", str, cls.profile),
            calibration=get("CALIBRATION", str, cls.calibration),
            polish=get("POLISH", int, cls.polish),
            refine=get("REFINE", int, cls.refine),
            even_bracket=get("EVEN_BRACKET", str, "1") != "0",
            emit_ffn1=get("EMIT_FFN1", str, "1") != "0",
            solver_s=get("SOLVER_S", float, None),
            sequential=get("SEQUENTIAL", str, "0") == "1",
            deadline_s=get("DEADLINE_S", float, cls.deadline_s),
        )

    @property
    def num_microbatches(self) -> int:
        return (self.microbatches if self.microbatches is not None
                else 4 * self.workers)


class BenchResult:
    """The best-so-far result line, printed exactly once: at the end of
    the run, on SIGTERM or SIGALRM, or after a crash."""

    def __init__(self, deadline_s: float):
        self.deadline_s = float(deadline_s)
        self.t0 = _process_start()
        self.phases_skipped: List[str] = []
        self.fields: Dict = dict(
            metric=None, value=None, unit="percent", vs_baseline=None,
            phases_skipped=self.phases_skipped,
            partial="startup: no measurement completed yet")
        self.emitted = False

    def elapsed(self) -> float:
        return time.time() - self.t0

    def time_left(self) -> float:
        return self.deadline_s - self.elapsed()

    def skip_phase(self, name: str) -> None:
        """Record that the deadline cut ``name`` short (``polish``,
        ``final_remeasure``, ``refine``, ``even_bracket``, ``ffn1``): an
        empty list says every enabled phase ran to its end."""
        if name not in self.phases_skipped:
            self.phases_skipped.append(name)

    def set_partial(self, why: Optional[str]) -> None:
        self.fields["partial"] = why

    def add_partial(self, why: str) -> None:
        prior = self.fields.get("partial")
        self.fields["partial"] = f"{prior}; {why}" if prior else why

    def emit(self) -> None:
        if self.emitted:
            return
        self.emitted = True
        out = dict(self.fields)
        out["elapsed_s"] = round(self.elapsed(), 1)
        out["deadline_s"] = self.deadline_s
        print(json.dumps(out), flush=True)


def check_partition(model_cfg: Sequence[Dict], wm: WorkerManager) -> None:
    """Refuse an allocation that is not a contiguous cover of every
    unit: the non-empty workers, in rank order (the pipeline's stage
    order), must hold ``model_cfg``'s units exactly once each, in order."""
    held = [unit for w in sorted(wm.worker_pool, key=lambda w: w.rank)
            for unit in (w.model_config or [])]
    if [id(u) for u in held] != [id(u) for u in model_cfg]:
        counts = [len(w.model_config or [])
                  for w in sorted(wm.worker_pool, key=lambda w: w.rank)]
        raise ValueError(
            f"allocation {counts} is not a contiguous cover of the "
            f"{len(model_cfg)} units")


def _stage_workers(wm: WorkerManager) -> List:
    """The workers that hold units, in pipeline order."""
    return [w for w in sorted(wm.worker_pool, key=lambda w: w.rank)
            if w.model_config]


class Bench:
    """One benchmark run.  :meth:`stage_times` is the only step that
    runs the model; tests replace it (with :meth:`make_profile` and
    :meth:`make_device_benchmarker`) to drive the whole pass from
    injected stage times."""

    def __init__(self, knobs: Knobs, result: BenchResult,
                 devices: Sequence[torch.device],
                 note: Optional[Callable[[str], None]] = None):
        self.knobs = knobs
        self.result = result
        self.devices = list(devices)
        self.note = note or (lambda msg: None)
        self.bert_cfg = bert_config(knobs.preset, hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0)
        self.model_cfg = self._layer_configs(knobs.ffn_shards)
        self.slowdowns = worker_slowdowns(knobs.workers, knobs.slowdown)
        self.mem_skew = memory_skew(knobs.workers)
        rng = np.random.default_rng(0)
        ids = rng.integers(5, self.bert_cfg.vocab_size,
                           size=(knobs.batch, SEQ_LEN)).astype(np.int32)
        self.data = (ids, np.zeros_like(ids), np.ones_like(ids))
        self.labels = rng.integers(0, 3, size=(knobs.batch,)).astype(
            np.int32)
        self.mem_budget_mb: Optional[float] = None
        self.layer_mem: List[float] = []
        self._ps: Optional[ParameterServer] = None
        self.last_pass_s = 0.0  # the most recent measurement pass
        self.full_pass_s = 0.0  # the last pass with no seeded times
        self.pass_s: List[Dict] = []

    # --- the parts that touch the device (tests replace them) ----------------
    def _layer_configs(self, ffn_shards: int) -> List[Dict]:
        return bert_layer_configs(self.bert_cfg,
                                  num_encoder_units=self.knobs.layer_num,
                                  num_classes=3, deterministic=True,
                                  ffn_shards=ffn_shards)

    def make_profile(self, model_cfg: List[Dict]) -> ModelBenchmarker:
        """The per-unit profile (timed on the first device, or static)."""
        return ModelBenchmarker(
            model_cfg,
            RandomTokenGenerator(batch_size=self.knobs.batch,
                                 seq_length=SEQ_LEN,
                                 vocab_size=self.bert_cfg.vocab_size),
            device=self.devices[0], timed=self.knobs.profile == "timed")

    def make_device_benchmarker(self, wm: WorkerManager):
        """The device profile: the proxy model timed on each worker's
        device, skewed by the paper's slowdowns and the memory skew."""
        return proxy_device_benchmarker(
            wm, iterations=5, devices=self.devices,
            stimulator=PaperSkew(self.slowdowns, self.mem_skew))

    def stage_times(self, wm: WorkerManager, label: str, repeats: int,
                    sanity: bool, seed_times: Optional[Dict]) -> List[float]:
        """Build the real pipeline for ``wm``'s allocation, optionally
        train one step (its loss must be finite), and return the raw
        per-stage seconds in pipeline order."""
        if self._ps is None:
            self._ps = ParameterServer(
                self.model_cfg, generator=torch.Generator().manual_seed(0))
        model = PipelineModel(wm, self._ps, sgd(1e-3), cross_entropy_loss,
                              devices=self.devices)
        if sanity:
            self.note(f"{label}: {len(model.stages)} stages built; one "
                      f"sanity train step...")
            loss = model.train_step(self.data, self.labels)
            if not np.isfinite(loss):
                raise RuntimeError(f"{label}: non-finite loss {loss}")
        on_cpu = self.devices[0].type == "cpu"
        return model.measure_stage_times(
            self.data, repeats=repeats, inner_iters="auto" if on_cpu else 3,
            seed_times=seed_times)

    # --- one measurement pass ------------------------------------------------
    def measure(self, wm: WorkerManager, label: str, repeats: int,
                sanity: bool = False, seed_times: Optional[Dict] = None
                ) -> Tuple[float, List[float]]:
        """The emulated step of ``wm``'s allocation and its raw stage
        times.  Each worker's ``slowdown`` is 1 while the pipeline is
        built and timed (the schedule model applies it to the raw times)
        and restored afterwards."""
        t0 = time.time()
        was_seeded = bool(seed_times)
        check_partition(self.model_cfg, wm)
        stages = _stage_workers(wm)
        stage_slowdowns = [float(w.extra_config["slowdown"]) for w in stages]
        saved = {id(w): w.extra_config.get("slowdown", 1.0)
                 for w in wm.worker_pool}
        for w in wm.worker_pool:
            w.extra_config["slowdown"] = 1.0
        try:
            measured = list(self.stage_times(wm, label, repeats, sanity,
                                             seed_times))
        finally:
            for w in wm.worker_pool:
                w.extra_config["slowdown"] = saved[id(w)]
        taus = [t * s for t, s in zip(measured, stage_slowdowns)]
        step = schedule_step_time(taus, self.knobs.num_microbatches,
                                  self.knobs.sequential)
        self.last_pass_s = time.time() - t0
        if not was_seeded:
            # a pass that consulted no earlier measurement is a full one:
            # the deadline gates size the final re-measurement from it
            self.full_pass_s = self.last_pass_s
        self.pass_s.append(dict(label=label,
                                seconds=round(self.last_pass_s, 3)))
        self.note(f"{label}: step={step:.6f}s layers="
                  f"{[len(w.model_config) for w in stages]} measured="
                  f"{[round(t, 6) for t in measured]} slowdowns="
                  f"{stage_slowdowns}; pass {self.last_pass_s:.1f}s")
        return step, measured

    def solver_budget(self) -> float:
        """Wall budget of one solve: bounded, so the solver's anneal
        cannot eat the measurement passes' time."""
        if self.knobs.solver_s is not None:
            return self.knobs.solver_s
        return min(90.0, max(10.0, self.result.time_left() * 0.06))

    def pool_config(self) -> List[Dict]:
        """One worker per slowdown, round-robined over the devices."""
        return [
            dict(name=f"node-{i}",
                 device_config=dict(device_index=i % len(self.devices)),
                 # the raw budget: the device profile divides it by the
                 # memory skew (applied once)
                 extra_config=dict(slowdown=float(self.slowdowns[i]),
                                   mem_limit=self.mem_budget_mb))
            for i in range(self.knobs.workers)]

    def pool(self) -> WorkerManager:
        wm = WorkerManager()
        wm.load_worker_pool_from_config(self.pool_config())
        return wm

    def record_best(self, even_step: float, opt_step: float,
                    gap: Optional[float], history: List[float],
                    partial: Optional[str]) -> None:
        """Refresh the result after every optimal-side measurement, so a
        kill at any later point still reports a measured number."""
        speedup = (even_step - opt_step) / even_step * 100
        self.result.fields.update(
            value=round(speedup, 2),
            vs_baseline=round(speedup / BASELINE_PCT, 4),
            solver_gap=_finite_or_none(gap),
            refine_steps=list(history), pass_s=self.pass_s)
        self.result.set_partial(partial)

    # --- the pass ------------------------------------------------------------
    def run(self) -> Dict:
        knobs, result, note = self.knobs, self.result, self.note
        device = self.devices[0]
        on_card = device.type == "cuda"
        kind = torch.cuda.get_device_name(device) if on_card else "cpu"
        mode = ("sequential" if knobs.sequential
                else f"GPipe-M{knobs.num_microbatches}")
        n_units = len(self.model_cfg)
        result.fields.update(
            metric=(f"{n_units}-unit stacked BERT-{knobs.preset} "
                    f"({knobs.layer_num} encoder layers, "
                    f"ffn/{knobs.ffn_shards}) {mode} step-time improvement, "
                    f"optimal vs even allocation, {knobs.workers} "
                    f"heterogeneous workers ({knobs.slowdown} slowdowns, "
                    f"{knobs.mem_regime} memory regime), measured on {kind}"),
            platform="gpu" if on_card else "cpu", device_kind=kind,
            units=n_units)

        model_bench = self.make_profile(self.model_cfg)
        note(f"model profile ({knobs.profile})...")
        t0 = time.time()
        _, self.layer_mem = model_bench.benchmark()
        profile_s = time.time() - t0
        note(f"model profile done in {profile_s:.1f}s: {n_units} units, "
             f"{sum(self.layer_mem) / 1024:.2f} GB estimate")
        self.mem_budget_mb = (
            knobs.mem_mb if knobs.mem_mb is not None
            else worker_mem_budget_mb(self.layer_mem, knobs.workers,
                                      knobs.mem_regime))
        note(f"memory regime {knobs.mem_regime!r}: raw per-worker budget "
             f"{self.mem_budget_mb:.0f} MB")

        # the even baseline
        even_wm = self.pool()
        Allocator(self.model_cfg, even_wm).even_allocate()
        even_step, even_measured = self.measure(
            even_wm, "even", knobs.repeats + 2)
        even_counts = [len(w.model_config) for w in _stage_workers(even_wm)]
        even_pass_s = self.last_pass_s
        result.fields.update(even_partition=even_counts)
        result.set_partial("even baseline measured; optimal pass did not "
                           "complete")

        # calibration from the even pass, then the solve
        wm = self.pool()
        allocator = Allocator(self.model_cfg, wm, model_bench,
                              self.make_device_benchmarker(wm))
        calib_fit = self._calibrate(allocator, even_counts, even_measured)
        t0 = time.time()
        allocator.optimal_allocate(max_time=self.solver_budget())
        solve_s = time.time() - t0
        solver_gap = allocator.last_result.optimality_gap
        opt_seed: Dict = {}
        # REPEATS + 2, the even side's count: where nothing re-measures
        # later, this is the optimal side of the headline subtraction
        best_step, measured = self.measure(
            wm, "optimal", knobs.repeats + 2, sanity=True,
            seed_times=opt_seed)
        best_gap = solver_gap
        best_snap = _snapshot(wm)
        history = [round(best_step, 6)]
        self.record_best(even_step, best_step, best_gap, history,
                         "initial optimal measured; refinement incomplete")

        ran_refines = 0
        for it in range(1, knobs.refine + 1):
            need = 1.05 * self.last_pass_s + solve_s + 60
            if result.time_left() < need:
                note(f"refine stopped before iteration {it}: "
                     f"{result.time_left():.0f}s left < {need:.0f}s needed")
                result.skip_phase("refine")
                break
            t0 = time.time()
            allocator.refine_allocation(measured,
                                        max_time=self.solver_budget())
            solve_s = time.time() - t0
            gap = allocator.last_result.optimality_gap
            step, measured = self.measure(wm, f"optimal+refine{it}",
                                          knobs.repeats)
            ran_refines = it
            history.append(round(step, 6))
            if step < best_step:
                best_step, best_gap, best_snap = step, gap, _snapshot(wm)
            self.record_best(even_step, best_step, best_gap, history,
                             f"best of {it} refine iterations; final "
                             f"re-measurement not yet run")

        best_step, best_snap, cur_step, ran_polish = self.polish(
            wm, allocator, measured, best_step, best_snap, even_step,
            even_pass_s, best_gap, history, opt_seed)

        # reserve the drift bracket's cost before the final re-measurement:
        # short of time, the final pass is the one to shed
        bracket_reserve = 0.55 * even_pass_s + 30 if knobs.even_bracket \
            else 0.0
        final_remeasured = False
        if ((ran_refines or ran_polish) and result.time_left()
                > 0.55 * self.full_pass_s + bracket_reserve + 45):
            # select on the loop's scores, report a fresh measurement of
            # the winner: the minimum over noisy draws is biased low
            _restore(best_snap)
            opt_step, _ = self.measure(wm, "optimal-selected",
                                       knobs.repeats + 2)
            history.append(round(opt_step, 6))
            final_remeasured = True
        elif ran_polish and not ran_refines:
            # the polish moves were chosen by prediction, never accepted
            # on a measurement, so the last step is an unbiased estimate
            note("final re-measurement skipped: insufficient budget; "
                 "reporting the last polish step")
            result.skip_phase("final_remeasure")
            opt_step = cur_step
        else:
            if ran_refines:
                note("final re-measurement skipped: insufficient budget; "
                     "reporting the best loop score")
                result.skip_phase("final_remeasure")
                _restore(best_snap)
            opt_step = best_step
        optimal_counts = [len(w.model_config) for w in _stage_workers(wm)]

        # the drift bracket: a second even measurement after the optimal
        # side, so a steady drift of the machine lands on both sides
        even_steps = [round(even_step, 6)]
        if knobs.even_bracket:
            if result.time_left() > 0.5 * even_pass_s + 30:
                e2, _ = self.measure(even_wm, "even-recheck",
                                     knobs.repeats + 2)
                even_steps.append(round(e2, 6))
                even_step = (even_step + e2) / 2.0
            else:
                note("even drift bracket skipped: insufficient budget")
                result.skip_phase("even_bracket")
        speedup = (even_step - opt_step) / even_step * 100

        value_ffn1 = None
        if knobs.emit_ffn1 and knobs.ffn_shards != 1:
            if result.time_left() > profile_s * 1.3 + 45:
                note("ffn/1 reference-granularity number (the static model "
                     "on an ffn/1 profile)...")
                costs1, mem1 = self.make_profile(
                    self._layer_configs(1)).benchmark()
                out1 = evaluate_instance(
                    costs1, mem1, self.slowdowns,
                    num_microbatches=knobs.num_microbatches,
                    mem_budget_mb=self.mem_budget_mb,
                    sequential=knobs.sequential)
                value_ffn1 = round(out1["speedup_pct"], 2)
                note(f"ffn/1 granularity: {value_ffn1}%")
            else:
                note("ffn/1 side number skipped: insufficient budget")
                result.skip_phase("ffn1")
        result.fields.update(
            value=round(speedup, 2),
            vs_baseline=round(speedup / BASELINE_PCT, 4),
            optimal_partition=optimal_counts,
            solver_gap=_finite_or_none(best_gap),
            refine_steps=history, even_steps=even_steps,
            polish_moves=ran_polish, final_remeasure=final_remeasured,
            calibration=calib_fit, value_ffn1_model=value_ffn1,
            pass_s=self.pass_s, partial=None)
        return result.fields

    def _calibrate(self, allocator: Allocator, even_counts: List[int],
                   even_measured: List[float]) -> Optional[Dict]:
        mode = self.knobs.calibration
        if mode == "types":
            # one cost per distinct unit config regressed from the even
            # pass: its only stochastic input is the stage-time medians
            fit = allocator.calibrate_costs_by_type(even_counts,
                                                    even_measured)
            self.note(f"fitted {len(fit)} type costs")
            return {"mode": "types",
                    "costs": [round(v, 8) for v in
                              sorted(fit.values(), reverse=True)]}
        if mode == "affine":
            a, b = allocator.calibrate_costs_affine(even_counts,
                                                    even_measured)
            return {"mode": "affine", "a": a, "b": b}
        if mode == "scale":
            allocator.calibrate_costs(even_counts, even_measured)
            return {"mode": "scale"}
        if mode != "0":
            raise ValueError(f"unknown calibration {mode!r}")
        return None

    def polish(self, wm: WorkerManager, allocator: Allocator,
               measured: List[float], best_step: float, best_snap,
               even_step: float, even_pass_s: float,
               best_gap: Optional[float], history: List[float],
               opt_seed: Dict):
        """Measured-time bottleneck polish (the reference's greedy
        rebalance, ``scaelum/dynamics/allocator.py:295-368``, driven by
        measured stage times).  Each move slides one unit off the stage
        with the largest emulated time through ``k`` intermediate stages
        (each keeps its count, its window shifts by one) to the stage at
        the chain's end, choosing the unvisited chain whose predicted
        maximum (calibrated unit costs over the changed ranges) is lowest
        and below the current one; a chain that would overfill a changed
        worker's memory is refused.  Returns the best step, its
        allocation, the last step and the number of moves."""
        knobs, result, note = self.knobs, self.result, self.note
        cur_step = best_step
        cost_sec = allocator._cost_override
        if knobs.polish <= 0 or cost_sec is None:
            return best_step, best_snap, cur_step, 0
        cost_prefix = np.concatenate([[0.0], np.cumsum(
            np.asarray(cost_sec, dtype=np.float64))])
        mem_prefix = np.concatenate([[0.0], np.cumsum(
            np.asarray(self.layer_mem, dtype=np.float64))])

        def cost_sum(a, b):
            return float(cost_prefix[b] - cost_prefix[a])

        def mem_sum(a, b):
            return float(mem_prefix[b] - mem_prefix[a])

        def worker_cap(w):
            raw = float(w.extra_config.get("mem_limit", self.mem_budget_mb))
            return raw / float(self.mem_skew[w.stim_index])

        cur_measured = list(measured)
        visited = set()
        move_est = 0.15 * self.full_pass_s  # refreshed from real moves
        ran = 0
        for it in range(1, knobs.polish + 1):
            # reserve only the drift bracket behind a move: the final
            # re-measurement is optional, the polish may rescue a bad draw
            need = move_est + 0.55 * even_pass_s + 75
            if result.time_left() < need:
                note(f"polish stopped before move {it}: "
                     f"{result.time_left():.0f}s left < {need:.0f}s needed")
                result.skip_phase("polish")
                break
            workers = _stage_workers(wm)
            S = len(workers)
            if S != len(cur_measured):
                break
            svals = [float(w.extra_config["slowdown"]) for w in workers]
            taus = [t * s for t, s in zip(cur_measured, svals)]
            cur_max = max(taus)
            b = taus.index(cur_max)
            ranges, pos = [], 0
            for w in workers:
                ranges.append((pos, pos + len(w.model_config)))
                pos += len(w.model_config)

            def chain_candidate(k, direction):
                lo, hi = ranges[b]
                if hi - lo <= 1:
                    return None
                end = b + k * direction
                if not 0 <= end < S:
                    return None
                new_ranges = list(ranges)
                if direction < 0:
                    new_ranges[b] = (lo + 1, hi)
                    for j in range(b - 1, end, -1):
                        a, e = ranges[j]
                        new_ranges[j] = (a + 1, e + 1)
                    a, e = ranges[end]
                    new_ranges[end] = (a, e + 1)
                else:
                    new_ranges[b] = (lo, hi - 1)
                    for j in range(b + 1, end):
                        a, e = ranges[j]
                        new_ranges[j] = (a - 1, e - 1)
                    a, e = ranges[end]
                    new_ranges[end] = (a - 1, e)
                pred = 0.0
                for j in range(S):
                    if new_ranges[j] == ranges[j]:
                        t_j = taus[j]
                    else:
                        if (mem_sum(*new_ranges[j])
                                > worker_cap(workers[j]) + 1e-9):
                            refused.append(j)
                            return None  # would overfill worker j
                        delta = (cost_sum(*new_ranges[j])
                                 - cost_sum(*ranges[j]))
                        t_j = (cur_measured[j] + delta) * svals[j]
                    pred = max(pred, t_j)
                return pred, new_ranges

            visited.add(tuple(ranges))
            # the best UNVISITED improving chain: predictions that
            # disagree with measurement would otherwise cycle between two
            # allocations, each move looking improving from the other side
            refused, priced = [], []
            for direction in (-1, +1):
                for k in range(1, S):
                    out = chain_candidate(k, direction)
                    if out:
                        priced.append(out)
            cands = sorted((o for o in priced
                            if o[0] < cur_max * (1.0 - 1e-3)),
                           key=lambda o: o[0])
            best = next(((p, nr) for p, nr in cands
                         if tuple(nr) not in visited), None)
            if best is None:
                note(f"polish converged after {it - 1} moves (no unvisited "
                     f"predicted-improving chain): "
                     + _polish_stop(b, ranges, taus, cur_max, priced,
                                    refused, [
                                        worker_cap(w) - mem_sum(*r)
                                        for w, r in zip(workers, ranges)],
                                    self.layer_mem))
                break
            best_pred, best_ranges = best
            for w, (a, e) in zip(workers, best_ranges):
                w.model_config = self.model_cfg[a:e]
            ran = it
            note(f"polish move {it}: predicted max {best_pred:.6f}s (was "
                 f"{cur_max:.6f}s)")
            cur_step, cur_measured = self.measure(
                wm, f"optimal+polish{it}", knobs.repeats + 2,
                seed_times=opt_seed)
            move_est = max(self.last_pass_s, 15.0)
            history.append(round(cur_step, 6))
            if cur_step < best_step:
                best_step, best_snap = cur_step, _snapshot(wm)
            self.record_best(even_step, best_step, best_gap, history,
                             f"best after {it} polish moves; final "
                             f"re-measurement not yet run")
        return best_step, best_snap, cur_step, ran


def _polish_stop(b, ranges, taus, cur_max, priced, refused, headroom_mb,
                 layer_mem) -> str:
    """Why the polish found no move: the bottleneck stage's units, the
    stages tied with it, how many chains were priced and refused for
    memory, the best priced maximum, and the memory headroom (cap less
    use) of the bottleneck's neighbours beside the unit each would
    take."""
    lo, hi = ranges[b]
    ties = sum(t >= cur_max * (1.0 - 1e-3) for t in taus)
    best = min((p for p, _ in priced), default=None)
    side = []
    for j, unit in ((b - 1, lo), (b + 1, hi - 1)):
        if 0 <= j < len(ranges):
            side.append(f"stage {j} {headroom_mb[j]:.1f} MB free for "
                        f"{float(layer_mem[unit]):.1f} MB")
    return (f"bottleneck stage {b} of {len(ranges)} holds {hi - lo} "
            f"unit(s) at {cur_max:.6f}s, {ties} stage(s) within 0.1% of "
            f"it; {len(priced)} chain(s) priced, best "
            + (f"{best:.6f}s" if best is not None else "none")
            + f", {len(refused)} refused for memory; "
            + ("; ".join(side) or "no neighbour"))


def _snapshot(wm: WorkerManager):
    return [(w, list(w.model_config or []), w.order, w.rank)
            for w in wm.worker_pool]


def _restore(snap) -> None:
    for w, mc, order, rank in snap:
        w.model_config = mc
        w.order = order
        w.rank = rank


def _finite_or_none(x: Optional[float]) -> Optional[float]:
    """A gap as JSON can carry it (an infinite gap is null)."""
    return round(float(x), 4) if x is not None and np.isfinite(x) else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="optimal-vs-even allocation benchmark (one JSON line)")
    parser.add_argument("--device",
                        help="run every stage here (e.g. cpu) instead of "
                             "on the cards")
    args = parser.parse_args(argv)
    knobs = Knobs.from_env(os.environ)
    result = BenchResult(knobs.deadline_s)

    def on_signal(signum, frame):
        result.add_partial(f"killed by signal {signum}")
        result.emit()
        os._exit(0)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGALRM, on_signal)
    # the backstop: should a phase overrun its estimate, the alarm still
    # prints the best result a little after the deadline
    signal.alarm(max(int(result.time_left()) + 60, 60))

    def note(msg: str) -> None:
        print(f"# [{time.strftime('%H:%M:%S')}] "
              f"[{result.time_left():.0f}s left] {msg}",
              file=sys.stderr, flush=True)

    try:
        devices = resolve_devices(None if args.device is None
                                  else [args.device])
        note(f"devices: {[str(d) for d in devices]}; {knobs}")
        Bench(knobs, result, devices, note).run()
    except Exception as exc:  # the result line must appear
        traceback.print_exc()
        result.set_partial(f"crashed: {type(exc).__name__}: {exc}")
        result.emit()
        return 1
    except KeyboardInterrupt:
        result.add_partial("interrupted")
        result.emit()
        raise
    finally:
        signal.alarm(0)
    result.emit()
    return 0


__all__ = ["Bench", "BenchResult", "Knobs", "check_partition", "main"]


if __name__ == "__main__":
    sys.exit(main())
