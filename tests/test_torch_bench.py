"""The port's bench (``python -m skycomputing_tpu_torch.bench``) on the
CPU: a full run at BERT ``tiny`` prints exactly one JSON line carrying
the output contract's fields, with even and optimal partitions that
cover every unit; a run sent SIGTERM mid-pass prints a line with
``partial`` set; from injected per-stage times at 8 workers, the even
pass, the ``types`` calibration and ``optimal_allocate`` give the JAX
``Allocator``'s partition on the same inputs; and the measured-time
polish makes the moves the JAX bench's rule makes (``bench.py:785-980``,
its partitions written out below as expected values)."""

import json
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu_torch import bench
from skycomputing_tpu_torch.dynamics import Allocator

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]

CONTRACT = ("metric", "value", "unit", "vs_baseline", "platform",
            "device_kind", "solver_gap", "refine_steps", "even_steps",
            "polish_moves", "final_remeasure", "calibration",
            "value_ffn1_model", "phases_skipped", "partial")

TINY_ENV = dict(SKYTPU_BENCH_PRESET="tiny", SKYTPU_BENCH_WORKERS="4",
                SKYTPU_BENCH_LAYER_NUM="2", SKYTPU_BENCH_REPEATS="1",
                SKYTPU_BENCH_BATCH="4")


def _bench_env(**extra):
    """The tiny bench's environment.  One intra-op thread: the run's
    tensors are tiny, and on a host whose cores other processes keep
    busy a thread per core oversubscribes them: beside eight busy
    processes on eight cores the run took 128 s with a thread per core
    and 8.5 s with one."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SKYTPU_BENCH_")}
    env.update(TINY_ENV, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **extra)
    return env


def test_full_run_prints_one_contract_line():
    proc = subprocess.run(
        [sys.executable, "-m", "skycomputing_tpu_torch.bench", "--device",
         "cpu"], cwd=ROOT, env=_bench_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(CONTRACT) <= set(line)
    assert line["unit"] == "percent" and line["platform"] == "cpu"
    assert line["partial"] is None and line["phases_skipped"] == []
    assert math.isfinite(line["value"])
    # value is rounded to 2 places, vs_baseline computed before rounding
    assert line["vs_baseline"] == pytest.approx(line["value"] / 55.0,
                                                abs=2e-4)
    units = line["units"]
    assert units == 1 + 2 * 4 + 2  # ffn/2: head, two shards, tail a layer
    for side in ("even_partition", "optimal_partition"):
        assert sum(line[side]) == units and min(line[side]) > 0, side
    assert line["even_partition"] == [3, 3, 3, 2]
    assert line["calibration"]["mode"] == "types"
    assert len(line["even_steps"]) == 2  # the drift bracket ran
    assert line["value_ffn1_model"] is not None
    assert "4 heterogeneous workers" in line["metric"]


def test_sigterm_mid_pass_prints_a_partial_line():
    proc = subprocess.Popen(
        [sys.executable, "-m", "skycomputing_tpu_torch.bench", "--device",
         "cpu"], cwd=ROOT, env=_bench_env(SKYTPU_BENCH_LAYER_NUM="4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if "model profile done" in line:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert "killed by signal 15" in line["partial"]
    assert line["platform"] == "cpu" and "metric" in line


def test_no_card_and_no_device_refuses(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    monkeypatch.setattr(signal, "alarm", lambda *a: 0)
    assert bench.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["partial"].startswith("crashed: RuntimeError: no CUDA")


def test_preflight_refuses_a_gap_or_a_reorder():
    """Before each pipeline is built the bench verifies the allocation
    (``verify_plan``, as the JAX bench does): a good even split passes
    with a summary note; a dropped unit and two swapped stages raise
    ``PlanError`` naming ``coverage``."""
    from skycomputing_tpu_torch.analysis import PlanError

    notes = []
    run = InjectedBench(_knobs())
    run.note = notes.append
    model_cfg = run.model_cfg
    wm = run.pool()
    Allocator(model_cfg, wm).even_allocate()
    run.preflight(wm, "even")
    assert notes[-1].startswith("even: pre-flight plan-check ok: 8 stages "
                                "/ 27 layers, checks=[coverage, shapes, "
                                "memory, donation]")
    second = wm.get_by_rank(1)
    kept = second.model_config
    second.model_config = kept[1:]  # its first unit dropped
    with pytest.raises(PlanError, match="coverage"):
        run.preflight(wm, "gap")
    second.model_config = kept
    first = wm.get_by_rank(0)
    first.rank, second.rank = 1, 0  # stages 0 and 1 swapped
    with pytest.raises(PlanError, match="coverage"):
        run.preflight(wm, "reorder")


# --- the pass driven by injected stage times --------------------------------

WORKERS, LAYERS = 8, 6  # 27 units at ffn/2
UNIT_MB, MEM_MB = 100.0, 900.0
UNIT_S = dict(BertEmbeddings=0.004, BertLayer_Head=0.003,
              BertLayer_BodyShard=0.0025, BertLayer_Tail=0.002,
              BertPooler=0.0005, BertTailForClassification=0.0003)


def raw_stage_s(model_cfg, start, end):
    """A stage's injected raw seconds: its units' times, a fixed cost
    per stage and a jitter set by where the slice lies — what the type
    fit cannot see, so that the polish has moves to make."""
    return (sum(UNIT_S[u["layer_type"]] for u in model_cfg[start:end])
            + 0.001 + 0.003 * ((3 * start + 7 * end) % 5))


def stage_ranges(wm):
    """(start, end) per non-empty worker in rank order."""
    out, pos = [], 0
    for w in sorted(wm.worker_pool, key=lambda w: w.rank):
        if w.model_config:
            out.append((pos, pos + len(w.model_config)))
            pos += len(w.model_config)
    return out


class FakeProfile:
    def __init__(self, model_cfg):
        self.model_cfg = model_cfg

    def benchmark(self):
        return ([UNIT_S[u["layer_type"]] for u in self.model_cfg],
                [UNIT_MB] * len(self.model_cfg))


class FakeDevices:
    """The device profile ``proxy_device_benchmarker`` gives: a proxy
    time times the worker's slowdown, its raw budget over its skew."""

    def __init__(self, wm, slowdowns, skew, budget):
        self.wm, self.slowdowns, self.skew = wm, slowdowns, skew
        self.budget = budget

    def benchmark(self):
        return {f"worker{w.rank}": dict(
            time=0.01 * float(self.slowdowns[w.stim_index]),
            avai_mem=self.budget / float(self.skew[w.stim_index]))
            for w in self.wm.worker_pool}


class InjectedBench(bench.Bench):
    """The bench with its device steps replaced by the injected instance;
    ``measured`` records each pass's label and partition."""

    def __init__(self, knobs):
        super().__init__(knobs, bench.BenchResult(knobs.deadline_s),
                         [torch.device("cpu")])
        self.measured = []

    def make_profile(self, model_cfg):
        return FakeProfile(model_cfg)

    def make_device_benchmarker(self, wm):
        return FakeDevices(wm, self.slowdowns, self.mem_skew,
                           self.mem_budget_mb)

    def stage_times(self, wm, label, repeats, sanity, seed_times):
        ranges = stage_ranges(wm)
        self.measured.append((label, [e - s for s, e in ranges]))
        return [raw_stage_s(self.model_cfg, s, e) for s, e in ranges]


def _knobs(**kw):
    return bench.Knobs(workers=WORKERS, layer_num=LAYERS, preset="tiny",
                       batch=4, microbatches=4 * WORKERS, mem_mb=MEM_MB,
                       repeats=1, emit_ffn1=False, solver_s=10.0, **kw)


def test_injected_times_solve_to_the_jax_allocators_partition():
    run = InjectedBench(_knobs(polish=0, even_bracket=False))
    line = run.run()
    assert line["partial"] is None and line["polish_moves"] == 0
    model_cfg = run.model_cfg
    assert len(model_cfg) == 27

    # the JAX Allocator on the same inputs
    jwm = JaxWorkerManager()
    jwm.load_worker_pool_from_config(run.pool_config())
    JaxAllocator(model_cfg, jwm, None, None).even_allocate()
    even = stage_ranges(jwm)
    assert [e - s for s, e in even] == line["even_partition"]
    wm = JaxWorkerManager()
    wm.load_worker_pool_from_config(run.pool_config())
    allocator = JaxAllocator(
        model_cfg, wm, FakeProfile(model_cfg),
        FakeDevices(wm, run.slowdowns, run.mem_skew, MEM_MB))
    fit = allocator.calibrate_costs_by_type(
        [e - s for s, e in even],
        [raw_stage_s(model_cfg, s, e) for s, e in even])
    assert line["calibration"]["costs"] == [
        round(v, 8) for v in sorted(fit.values(), reverse=True)]
    allocator.optimal_allocate(max_time=10.0)
    want = [e - s for s, e in stage_ranges(wm)]
    assert line["optimal_partition"] == want
    assert run.measured[1] == ("optimal", want)
    assert line["solver_gap"] == pytest.approx(
        allocator.last_result.optimality_gap, abs=1e-4)


# the passes the JAX bench's rule measures on this instance (bench.py's
# main() with its pipeline, profilers and plan check replaced by the same
# injected stage times, profile and device times): the even split, the
# solve, six polish moves (the fourth returns a unit the third took, a
# chain through two stages in the fifth), the best of them measured
# afresh, the even split again; and the result line's numbers
JAX_PASSES = [
    ("even", [4, 4, 4, 3, 3, 3, 3, 3]),
    ("optimal", [3, 2, 3, 2, 5, 3, 5, 4]),
    ("optimal+polish1", [3, 2, 3, 1, 6, 3, 5, 4]),
    ("optimal+polish2", [3, 1, 3, 2, 6, 3, 5, 4]),
    ("optimal+polish3", [3, 1, 3, 1, 7, 3, 5, 4]),
    ("optimal+polish4", [3, 1, 3, 1, 7, 4, 5, 3]),
    ("optimal+polish5", [3, 1, 3, 2, 7, 3, 5, 3]),
    ("optimal+polish6", [3, 2, 3, 1, 7, 3, 5, 3]),
    ("optimal-selected", [3, 1, 3, 1, 7, 3, 5, 4]),
    ("even-recheck", [4, 4, 4, 3, 3, 3, 3, 3]),
]
JAX_LINE = dict(value=8.06, polish_moves=6, final_remeasure=True,
                solver_gap=0.0207, even_steps=[0.1114, 0.1114],
                refine_steps=[0.1197, 0.1159, 0.116, 0.1024, 0.1101, 0.1152,
                              0.1151, 0.1024])


def test_polish_makes_the_jax_bench_moves():
    run = InjectedBench(_knobs(polish=6, even_bracket=True))
    line = run.run()
    assert line["partial"] is None and line["phases_skipped"] == []
    assert run.measured == JAX_PASSES
    assert line["optimal_partition"] == JAX_PASSES[-2][1]
    for key, want in JAX_LINE.items():
        assert line[key] == pytest.approx(want, abs=1e-4), key


def test_polish_stops_on_times_the_fit_explains_and_says_why():
    """On stage times that are exactly the sums of their units' costs the
    solver's partition is already the best the fit can see: the polish
    makes no move, and its note names the bottleneck, its ties, and the
    chains priced and refused for memory."""
    notes = []

    class ExactBench(InjectedBench):
        def __init__(self, knobs):
            super().__init__(knobs)
            self.note = notes.append

        def stage_times(self, wm, label, repeats, sanity, seed_times):
            ranges = stage_ranges(wm)
            self.measured.append((label, [e - s for s, e in ranges]))
            return [sum(UNIT_S[u["layer_type"]] for u in self.model_cfg[s:e])
                    for s, e in ranges]

    line = ExactBench(_knobs(polish=6, even_bracket=False)).run()
    assert line["partial"] is None and line["polish_moves"] == 0
    (stop,) = [n for n in notes if n.startswith("polish converged")]
    assert stop.startswith("polish converged after 0 moves (no unvisited "
                           "predicted-improving chain): bottleneck stage 4 "
                           "of 8 holds 5 unit(s) at 0.037500s, 3 stage(s) "
                           "within 0.1% of it; 3 chain(s) priced, best "
                           "0.045000s, 4 refused for memory; stage 3 ")
