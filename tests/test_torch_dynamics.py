"""Profiling and allocation port contracts on the CPU, against the JAX
package on the same numpy inputs: static unit profiles (memory equal,
FLOPs within the stated per-unit ratio, none at 0) for BERT ``tiny``,
the proxy layers and the zoo's later units (long BERT, MoE GPT, ResNet,
each with its stack's partition), the timed profile, the device benchmarker and its
caches, every ``Allocator`` strategy and calibration over identical
injected profiles (the contracts of ``tests/test_dynamics.py``), the
config loader, the data generators and the builder factories."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.builder import proxy_layers as jproxy
from skycomputing_tpu.config import load_config as jax_load_config
from skycomputing_tpu.dataset import DataloaderGenerator as JaxLoaderGen
from skycomputing_tpu.dataset import RandomTensorGenerator as JaxTensors
from skycomputing_tpu.dataset import RandomTokenGenerator as JaxTokens
from skycomputing_tpu.dataset.datasets import RandomBertDataset as JaxBert
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import Estimator as JaxEstimator
from skycomputing_tpu.dynamics import ModelBenchmarker as JaxModelBench
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.dynamics.solver import (
    solve_contiguous_minmax as jax_solve_contiguous_minmax,
)
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu_torch.builder import (
    build_data_generator,
    build_dataloader_from_cfg,
    build_hook,
    build_module_from_cfg,
    proxy_layers,
)
from skycomputing_tpu_torch.config import load_config
from skycomputing_tpu_torch.dataset import (
    DataloaderGenerator,
    RandomBertDataset,
    RandomTensorGenerator,
    RandomTokenGenerator,
)
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    DeviceBenchmarker,
    Estimator,
    ModelBenchmarker,
    WorkerManager,
    device_available_memory_mb,
)
from skycomputing_tpu_torch.dynamics.allocator import unit_groups
from skycomputing_tpu_torch.dynamics.solver import solve_contiguous_minmax
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.runner import StopHook
from skycomputing_tpu_torch.stimulator import Stimulator

pytestmark = pytest.mark.torch_port

CPU = [torch.device("cpu")]
LAUNCH_CONFIG = (Path(__file__).resolve().parents[1]
                 / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py")

# port FLOPs / JAX FLOPs per unit type, by (dtype, dropout on).  The
# products agree; the rest is elementwise work, which the port counts
# with XLA's costs: its erf-gelu at 64 FLOPs per element, a dropout
# mask at 55 (threefry bits and compare; the port's bernoulli_), an
# embedding gather at 1 per element it returns and 6 per index, and in
# bfloat16 a convert per element of every bf16 operand and result and
# the cast of the whole embedding table (flax casts the table, the port
# the rows it gathers; XLA charges the table).  Every unit reads within
# DEFAULT_RATIO.
FLOP_RATIO = {
    ("float32", False): {},
    ("bfloat16", False): {},
    ("float32", True): {},
    ("bfloat16", True): {},
}
DEFAULT_RATIO = (0.90, 1.10)


def _cfgs(pkg_config, pkg_layers, dtype, flash, units=2, dropout=False):
    """BERT ``tiny`` units, deterministic; with ``dropout``, hidden
    dropout 0.1 and (einsum attention only: the flash kernel has none)
    attention dropout 0.1, the units as the launcher builds them."""
    cfg = pkg_config("tiny", dtype=dtype,
                     hidden_dropout_prob=0.1 if dropout else 0.0,
                     attention_probs_dropout_prob=(
                         0.1 if dropout and not flash else 0.0),
                     use_flash_attention=flash)
    return pkg_layers(cfg, num_encoder_units=units,
                      deterministic=not dropout)


@pytest.mark.parametrize("dtype, flash, dropout", [
    pytest.param(dtype, flash, dropout,
                 id=f"{dtype}-{'flash' if flash else 'einsum'}"
                 + ("-dropout" if dropout else ""))
    for dropout in (False, True)
    for dtype in ("float32", "bfloat16")
    for flash in (False, True)
])
def test_static_profile_matches_jax(dtype, flash, dropout):
    port_cfg = _cfgs(bert_config, bert_layer_configs, dtype, flash,
                     dropout=dropout)
    jax_cfg = _cfgs(jax_bert_config, jax_bert_layers, dtype, flash,
                    dropout=dropout)
    bench = ModelBenchmarker(port_cfg, RandomTokenGenerator(2, 16, 1024))
    flops, mem = bench.benchmark()
    ref_flops, ref_mem = JaxModelBench(jax_cfg,
                                       JaxTokens(2, 16, 1024)).benchmark()
    assert mem == ref_mem  # the formula over equal shapes, bit for bit
    assert bench.distinct_units == 6
    assert all(f > 0 for f in flops)
    for unit, got, ref in zip(port_cfg, flops, ref_flops):
        lo, hi = FLOP_RATIO[dtype, dropout].get(unit["layer_type"],
                                                DEFAULT_RATIO)
        assert lo <= got / ref <= hi, (unit["layer_type"], got / ref)
    assert flops[1:4] == flops[4:7]  # repeated encoder trios
    assert bench.benchmark() is bench.benchmark()  # computed once


DRAWS = [3.32, 2.32, 3.58, 3.09]  # the stimulator's draws at 4 workers


def _launcher_profiles():
    """The launcher's own units (``configs/bert_pipeline.py`` as the
    environment sets it, preset large) and the JAX package's for the
    same config, each
    profiled statically by its package at batch 32 x 128: (port units,
    (FLOPs, memory), (JAX FLOPs, JAX memory))."""
    port_units = load_config(str(LAUNCH_CONFIG)).model_config
    cfg = port_units[0]["config"]
    jax_units = jax_bert_layers(
        jax_bert_config("large",
                        use_flash_attention=cfg["use_flash_attention"],
                        attention_probs_dropout_prob=cfg[
                            "attention_probs_dropout_prob"]),
        num_encoder_units=(len(port_units) - 3) // 3, num_classes=3)
    assert port_units[0]["config"] == jax_units[0]["config"]
    vocab = cfg["vocab_size"]
    port = ModelBenchmarker(port_units,
                            RandomTokenGenerator(32, 128, vocab)).benchmark()
    ref = JaxModelBench(jax_units, JaxTokens(32, 128, vocab)).benchmark()
    return port_units, port, ref


def _ratio_by_type(units, flops, ref_flops):
    ratios = {}
    for unit, got, ref in zip(units, flops, ref_flops):
        ratios.setdefault(unit["layer_type"], got / ref)
    return ratios


def _partition(result):
    return [end - start for start, end in result.slices], result.device_order


def test_launcher_static_partition_equals_jax(monkeypatch):
    """The launcher's own units (``configs/bert_pipeline.py`` at 24
    layers with flash: BERT-large, bf16, hidden dropout 0.1), profiled
    statically at batch 32 x 128 by each package and solved over the
    stimulator's draws with unbounded memory, give one partition and
    one device order: dropout's mask generation is counted alike."""
    for key, value in (("SKYTPU_LAYER_NUM", "24"), ("SKYTPU_FLASH", "1"),
                       ("SKYTPU_PRESET", "large")):
        monkeypatch.setenv(key, value)
    units, (flops, mem), (ref_flops, ref_mem) = _launcher_profiles()
    assert len(units) == 75
    assert all(u["deterministic"] is False for u in units)
    assert units[0]["config"]["hidden_dropout_prob"] == 0.1
    assert mem == ref_mem
    unbounded = [float("inf")] * 4
    got = solve_contiguous_minmax(flops, mem, DRAWS, unbounded)
    ref = jax_solve_contiguous_minmax(ref_flops, ref_mem, DRAWS, unbounded)
    assert _partition(got) == _partition(ref)


def test_proxy_layers_profile_and_forward_match_jax():
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    port = proxy_layers.MatmulStack(features=64, depth=2, dtype="float32")
    ref = jproxy.MatmulStack(features=64, depth=2, dtype="float32")
    _, flops, mem = Estimator.benchmark_model(
        proxy_layers.MatmulStack(features=64, depth=2, dtype="float32"), x)
    _, ref_flops, ref_mem = JaxEstimator.benchmark_model(ref, x)
    assert mem == ref_mem
    assert 0.9 <= flops / ref_flops <= 1.1
    assert Estimator.estimate_memory(
        proxy_layers.MatmulStack(features=64, depth=2, dtype="float32"),
        x)[1] == JaxEstimator.estimate_memory(ref, x)[1] == ref_mem
    params = ref.init(jax.random.key(0), x)["params"]
    for i, layer in enumerate(port.mm):
        layer.weight.data = torch.from_numpy(
            np.asarray(params[f"mm_{i}"]["kernel"]).T.copy())
        layer.bias.data = torch.from_numpy(
            np.asarray(params[f"mm_{i}"]["bias"]).copy())
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref.apply({"params": params}, x)), rtol=1e-5, atol=1e-5)

    img = np.random.default_rng(1).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    conv = proxy_layers.Conv2d(3, 5, kernel_size=3, padding=1, stride=2)
    jconv = jproxy.Conv2d(3, 5, kernel_size=3, padding=1, stride=2)
    p = jconv.init(jax.random.key(1), img)["params"]["Conv_0"]
    conv.weight.data = torch.from_numpy(
        np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(np.asarray(p["bias"]).copy())
    np.testing.assert_allclose(
        conv(torch.from_numpy(img)).detach().numpy(),
        np.asarray(jconv.apply({"params": {"Conv_0": p}}, img)),
        rtol=1e-5, atol=1e-5)
    assert Estimator.benchmark_model(
        proxy_layers.Conv2d(3, 5, padding=1), img)[2] == \
        JaxEstimator.benchmark_model(jproxy.Conv2d(3, 5, padding=1), img)[2]


def test_timed_profile_measures_each_distinct_unit_once(monkeypatch):
    model_cfg = _cfgs(bert_config, bert_layer_configs, "float32", True, 3)
    calls = []
    timed = Estimator.benchmark_train_time

    def counting(module, data, **kw):
        calls.append(type(module).__name__)
        return timed(module, data, **kw)

    monkeypatch.setattr(Estimator, "benchmark_train_time",
                        staticmethod(counting))
    bench = ModelBenchmarker(model_cfg, RandomTokenGenerator(2, 16, 1024),
                             device="cpu", timed=True, timed_iterations=2)
    cost, mem = bench.benchmark()
    static = ModelBenchmarker(model_cfg, RandomTokenGenerator(2, 16, 1024))
    assert len(cost) == len(model_cfg) == 12
    assert all(c > 0 for c in cost)
    assert calls == ["BertEmbeddings", "BertLayer_Head", "BertLayer_Body",
                     "BertLayer_Tail", "BertPooler",
                     "BertTailForClassification"]
    assert mem == static.benchmark()[1]
    assert cost[1:4] == cost[4:7] == cost[7:10]


def test_timed_profile_without_a_card_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    bench = ModelBenchmarker(_cfgs(bert_config, bert_layer_configs,
                                   "float32", False, 1),
                             RandomTokenGenerator(2, 8, 1024), timed=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.benchmark()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBenchmarker(_pool(WorkerManager, 2), None, [])


def test_estimator_timing_without_a_card_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    unit = proxy_layers.MatmulStack(features=8, depth=1, dtype="float32")
    x = np.ones((2, 8), np.float32)
    for timing in (Estimator.benchmark_speed, Estimator.benchmark_train_time):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timing(unit, (x,))
        assert timing(unit, (x,), device="cpu", iterations=1) is not None


def _pool(manager_cls, n, mem_limit=-1):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i),
             extra_config=dict(mem_limit=mem_limit, slowdown=1.0))
        for i in range(n)
    ])
    return wm


PROXY = [dict(layer_type="MatmulStack", features=64, depth=2,
              dtype="float32")]


def test_device_benchmarker_times_one_device_once_and_skews_per_worker():
    wm = _pool(WorkerManager, 4)
    stim = Stimulator(4)
    bench = DeviceBenchmarker(wm, RandomTensorGenerator(size=(4, 64)), PROXY,
                              iterations=3, devices=CPU, stimulator=stim)
    measured = []
    measure = bench._measure_device
    bench._measure_device = lambda d, x: measured.append(d) or measure(d, x)
    hot = bench.benchmark()
    assert measured == [torch.device("cpu")]  # four workers, one device
    raw = bench._device_time_cache[torch.device("cpu")]
    assert raw > 0
    for w in wm.worker_pool:
        got = hot[f"worker{w.rank}"]
        assert got["time"] == pytest.approx(
            raw * stim.compute_slowdown(w.stim_index))
        assert got["avai_mem"] > 0
    assert bench.benchmark() == hot  # per-worker cache: no re-timing
    assert measured == [torch.device("cpu")]
    assert len({stim.compute_slowdown(i) for i in range(4)}) == 4


def test_device_benchmarker_memory_limit_and_stimulate_env(monkeypatch):
    monkeypatch.setenv("STIMULATE", "1")
    wm = _pool(WorkerManager, 3, mem_limit=1000.0)
    bench = DeviceBenchmarker(wm, RandomTensorGenerator(size=(4, 64)), PROXY,
                              iterations=2, devices=CPU)
    out = bench.benchmark()
    stim = Stimulator(3)
    for i in range(3):
        assert out[f"worker{i}"]["avai_mem"] == pytest.approx(
            1000.0 / stim.memory_slowdown(i))
    assert device_available_memory_mb("cpu") > 0


# ------------------------------------------------------------- allocation
class FakeDeviceBenchmarker:
    """Profiles keyed by current rank, looked up by stable stim_index —
    the real benchmarker's behaviour after allocation re-ranks."""

    def __init__(self, times, mems, wm):
        self._times, self._mems, self._wm = times, mems, wm

    def benchmark(self):
        return {f"worker{w.rank}": dict(time=self._times[w.stim_index],
                                        avai_mem=self._mems[w.stim_index])
                for w in self._wm.worker_pool}


class FakeModelBenchmarker:
    def __init__(self, flops, mems):
        self._flops, self._mems = flops, mems

    def benchmark(self):
        return list(self._flops), list(self._mems)


def _true_stage_seconds(wm, pressure=0.1):
    """Measured seconds with a superlinear slice-size penalty."""
    return [len(w.model_config) * (1.0 + pressure * (len(w.model_config) - 1))
            for w in sorted((w for w in wm.worker_pool if w.model_config),
                            key=lambda w: w.order)]


def _fusion_stage_seconds(wm, saving=0.2):
    """Measured seconds with a sublinear slice-size effect."""
    return [len(w.model_config) * (1.0 - saving * (1.0 - 1.0
                                                   / len(w.model_config)))
            for w in sorted((w for w in wm.worker_pool if w.model_config),
                            key=lambda w: w.order)]


def _refine(rounds, measure, **kw):
    def run(alloc, wm):
        alloc.optimal_allocate()
        for _ in range(rounds):
            alloc.refine_allocation(measure(wm), **kw)
    return run


def _calls(*steps):
    def run(alloc, wm):
        return [step(alloc, wm) for step in steps]
    return run


ALTERNATING = [dict(layer_type="Dense", features=8),
               dict(layer_type="Dense", features=16)] * 6

# name -> (device times, device mems, layer costs, layer mems, operations,
# layer configs or None for distinct ones)
SCENARIOS = {
    "even_remainder": ([1, 1, 1], [100] * 3, [1] * 8, [1] * 8,
                       lambda a, w: a.even_allocate(), None),
    "optimal_prefers_fast": ([1.0, 1.0, 5.0], [1000.0] * 3, [1.0] * 30,
                             [0.1] * 30, lambda a, w: a.optimal_allocate(),
                             None),
    "optimal_respects_memory": ([0.1, 1.0, 1.0], [2.0, 100.0, 100.0],
                                [1.0] * 12, [1.0] * 12,
                                lambda a, w: a.optimal_allocate(), None),
    "optimal_drops_a_useless_worker": ([1.0, 1.0, 1.0, 500.0],
                                       [1000.0] * 4, [1.0] * 12, [0.1] * 12,
                                       lambda a, w: a.optimal_allocate(),
                                       None),
    "optimal_uneven_costs": ([1.0, 1.3, 2.0], [1000.0] * 3,
                             list(np.linspace(1, 2, 9)), [0.1] * 9,
                             lambda a, w: a.optimal_allocate(), None),
    "dynamic_balances": ([1.0, 2.0], [1000.0] * 2, [1.0] * 12, [0.1] * 12,
                         lambda a, w: a.dynamic_allocate(), None),
    "dynamic_memory_repair": ([1.0, 1.0, 1.0], [3.5, 100.0, 100.0],
                              [1.0] * 12, [1.0] * 12,
                              lambda a, w: a.dynamic_allocate(), None),
    "refine_closes_gap": ([1.0, 1.0, 2.0, 4.0], [1000.0] * 4, [1.0] * 24,
                          [0.1] * 24, _refine(3, _true_stage_seconds), None),
    "refine_converges": ([1.0, 1.5, 3.0], [1000.0] * 3, [1.0] * 18,
                         [0.1] * 18, _refine(6, _fusion_stage_seconds),
                         None),
    "refine_dropped_workers": ([1.0, 1.0, 1.0, 500.0], [1000.0] * 4,
                               [1.0] * 12, [0.1] * 12,
                               _refine(1, _true_stage_seconds), None),
    "refine_devices": ([1.0] * 3, [1000.0] * 3, [1.0] * 12, [0.1] * 12,
                       _calls(lambda a, w: a.even_allocate() and None,
                              lambda a, w: a.refine_allocation(
                                  [12.0, 4.0, 4.0], damping=1.0,
                                  attribute="devices") and None,
                              lambda a, w: a.stage_divergence(
                                  _true_stage_seconds(w))), None),
    "calibrate_costs_even_seed": (
        [1.0, 1.0, 2.0, 2.0], [1000.0] * 4, [1.0] * 16, [0.1] * 16,
        _calls(lambda a, w: a.calibrate_costs([4] * 4, [4.0, 4.0, 12.0,
                                                        12.0]),
               lambda a, w: a.optimal_allocate() and None), None),
    "calibrate_costs_damped": (
        [1.0, 2.0], [1000.0] * 2, [1.0, 2.0] * 4, [0.1] * 8,
        _calls(lambda a, w: a.calibrate_costs([3, 5], [2.0, 9.0],
                                              damping=0.5)), None),
    "affine_known_model": (
        [1.0, 1.0, 2.0], [1000.0] * 3, [1.0, 2.0, 3.0] * 4, [0.1] * 12,
        _calls(lambda a, w: a.calibrate_costs_affine(
            [3, 4, 5], [2.0 * 6 + 0.25 * 3, 2.0 * 8 + 0.25 * 4,
                        2.0 * 10 + 0.25 * 5])), None),
    "affine_degenerate": ([1.0, 1.0], [1000.0] * 2, [1.0] * 8, [0.1] * 8,
                          _calls(lambda a, w: a.calibrate_costs_affine(
                              [4, 4], [2.0, 2.0])), None),
    "affine_then_refine": (
        [1.0, 2.0, 4.0], [1000.0] * 3, [1.0] * 12, [0.1] * 12,
        _calls(lambda a, w: a.even_allocate() and None,
               lambda a, w: a.calibrate_costs_affine([4, 4, 4],
                                                     [1.2, 1.4, 1.6]),
               lambda a, w: a.optimal_allocate() and None,
               lambda a, w: a.refine_allocation(
                   [0.3 * len(x.model_config) for x in sorted(
                       w.worker_pool, key=lambda x: x.order)
                    if x.model_config]) and None), None),
    "by_type_recovers": (
        [1.0, 1.0, 2.0], [1000.0] * 3, [1.0] * 12, [0.1] * 12,
        _calls(lambda a, w: a.calibrate_costs_by_type(
            [3, 4, 5], [0.3 * 2 + 0.7, 0.3 * 2 + 0.7 * 2,
                        0.3 * 3 + 0.7 * 2]),
               lambda a, w: a.optimal_allocate() and None), ALTERNATING),
    "by_type_clamps_and_floors": (
        [1.0, 1.0], [1000.0] * 2, [1.0] * 8, [0.1] * 8,
        _calls(lambda a, w: a.calibrate_costs_by_type([6, 2], [6.0, 0.01])),
        [ALTERNATING[0]] * 6 + [ALTERNATING[1]] * 2),
    "device_scales_json_keys": (
        [1.0] * 3, [1000.0] * 3, [1.0] * 12, [0.1] * 12,
        _calls(lambda a, w: a.even_allocate() and None,
               lambda a, w: a.apply_device_scales({"1": 4.0}),
               lambda a, w: a.optimal_allocate() and None), None),
    "snapshot_restore": (
        [1.0, 2.0], [1000.0] * 2, [1.0] * 8, [0.1] * 8,
        _calls(lambda a, w: a.calibrate_costs([4, 4], [1.0, 3.0]),
               lambda a, w: a.snapshot_calibration()["cost"],
               lambda a, w: a.restore_calibration(
                   dict(cost=None, speed={})),
               lambda a, w: a.optimal_allocate() and None), None),
}


def _world(manager_cls, alloc_cls, times, mems, flops, lmem, cfgs):
    # fresh dicts: a slice is told apart by the identity of its first
    model_cfg = ([dict(c) for c in cfgs] if cfgs else
                 [dict(layer_type="Dense", features=8, unit=i)
                  for i in range(len(flops))])
    wm = _pool(manager_cls, len(times))
    alloc = alloc_cls(model_cfg, wm, FakeModelBenchmarker(flops, lmem),
                      FakeDeviceBenchmarker(times, mems, wm))
    return alloc, wm


def _state(alloc, wm):
    """What an allocation leaves: per worker (name, rank, order, index of
    its first layer and its length), the cost override and the
    device-speed override by stable index."""
    index = {id(c): i for i, c in enumerate(alloc.model_config)}
    workers = sorted(
        (w.name, w.rank, w.order,
         index[id(w.model_config[0])] if w.model_config else None,
         len(w.model_config or []))
        for w in wm.worker_pool)
    return workers, alloc._cost_override, alloc.device_scales()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocator_equals_jax(name):
    times, mems, flops, lmem, ops, cfgs = SCENARIOS[name]
    results = []
    for manager_cls, alloc_cls in ((JaxWorkerManager, JaxAllocator),
                                   (WorkerManager, Allocator)):
        alloc, wm = _world(manager_cls, alloc_cls, times, mems, flops, lmem,
                           cfgs)
        out = ops(alloc, wm)
        if out is wm:  # the strategies return the pool they wrote
            out = None
        results.append((out, _state(alloc, wm)))
        # an allocation puts every layer on one worker, in pipeline order
        covered = [c for w in sorted(wm.worker_pool, key=lambda w: w.rank)
                   for c in (w.model_config or [])]
        assert covered in ([], alloc.model_config)
    (got, got_state), (ref, ref_state) = results[1], results[0]
    assert got_state == ref_state
    assert json.dumps(got, default=str) == json.dumps(ref, default=str)


ERRORS = {
    "refine_mismatched_stages": lambda a: (a.optimal_allocate(),
                                           a.refine_allocation([0.1])),
    "refine_unknown_attribute": lambda a: (a.even_allocate(),
                                           a.refine_allocation(
                                               [4.0, 4.0],
                                               attribute="vibes")),
    "calibrate_costs_counts": lambda a: a.calibrate_costs([4, 4],
                                                          [1.0, 2.0, 3.0]),
    "calibrate_costs_coverage": lambda a: a.calibrate_costs([4, 3],
                                                            [1.0, 2.0]),
    "affine_counts": lambda a: a.calibrate_costs_affine([4, 4], [1.0]),
    "affine_coverage": lambda a: a.calibrate_costs_affine([4, 3],
                                                          [1.0, 2.0]),
    "by_type_counts": lambda a: a.calibrate_costs_by_type([4, 4], [1.0]),
    "by_type_coverage": lambda a: a.calibrate_costs_by_type([4, 3],
                                                            [1.0, 2.0]),
    "divergence_stages": lambda a: (a.even_allocate(),
                                    a.stage_divergence([1.0])),
}


@pytest.mark.parametrize("name", sorted(ERRORS) + ["dynamic_no_memory"])
def test_allocator_errors_fire_like_jax(name):
    mems = [0.05, 100.0] if name == "dynamic_no_memory" else [1000.0] * 2
    op = ERRORS.get(name, lambda a: a.dynamic_allocate())
    exc = RuntimeError if name == "dynamic_no_memory" else ValueError
    for manager_cls, alloc_cls in ((JaxWorkerManager, JaxAllocator),
                                   (WorkerManager, Allocator)):
        alloc, _ = _world(manager_cls, alloc_cls, [1.0, 2.0], mems,
                          [1.0] * 8, [0.1] * 8, None)
        with pytest.raises(exc):
            op(alloc)


def test_unit_groups_of_bert():
    cfgs = _cfgs(bert_config, bert_layer_configs, "float32", True, 3)
    assert unit_groups(cfgs) == ["first"] + ["stack"] * 9 + ["last"] * 2
    # no repeated unit: each its own group, as the per-type fit
    distinct = [dict(layer_type="Dense", features=8, unit=i) for i in range(3)]
    assert unit_groups(distinct) == [json.dumps(c, sort_keys=True)
                                     for c in distinct]


def _group_world(profile):
    cfgs = _cfgs(bert_config, bert_layer_configs, "float32", True, 8)
    wm = _pool(WorkerManager, 4)
    alloc = Allocator(cfgs, wm, FakeModelBenchmarker(profile, [0.1] * len(profile)),
                      FakeDeviceBenchmarker([1.0, 2.0, 1.0, 3.0],
                                            [1000.0] * 4, wm))
    return alloc, cfgs


def test_calibrate_costs_by_group_recovers_scales_per_type_cannot():
    """BERT's 27 units over 4 stages: 3 group scales are identified, and
    the fit recovers them exactly where the 6 per-type costs are not."""
    # profile: embeddings, the three thirds, pooler, classifier
    profile = [3.0] + [6.0, 2.0, 2.5] * 8 + [1.0, 0.5]
    scale = {"first": 0.5, "stack": 0.8, "last": 2.0}
    alloc, cfgs = _group_world(profile)
    truth = [scale[g] * c for g, c in zip(unit_groups(cfgs), profile)]
    counts = [7, 7, 7, 6]
    bounds = np.cumsum([0] + counts)
    stage_s = [sum(truth[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    fit = alloc.calibrate_costs_by_group(counts, stage_s)
    assert fit == pytest.approx(scale, rel=1e-9)
    assert alloc._cost_override == pytest.approx(truth, rel=1e-9)
    alloc.optimal_allocate()
    by_type, _ = _group_world(profile)
    by_type.calibrate_costs_by_type(counts, stage_s)
    assert by_type._cost_override != pytest.approx(truth, rel=1e-3)
    # a noisy stage cannot zero a group: clamped, then floored
    alloc.calibrate_costs_by_group(counts, [stage_s[0], 1e-6, 1e-6,
                                            stage_s[3]])
    assert min(alloc._cost_override) > 0


@pytest.mark.parametrize("counts,times,match", [
    ([7, 7, 7], [1.0, 1.0, 1.0, 1.0], "measured times"),
    ([7, 7, 6, 6], [1.0] * 4, "cover 26 layers"),
])
def test_calibrate_costs_by_group_rejects(counts, times, match):
    alloc, _ = _group_world([1.0] * 27)
    with pytest.raises(ValueError, match=match):
        alloc.calibrate_costs_by_group(counts, times)


def test_launcher_static_partition_equals_jax_under_gpt(monkeypatch,
                                                       tmp_path):
    """``SKYTPU_MODEL=gpt`` (fault C4): the launcher's GPT at BERT-large's
    width (hidden 1,024, 16 heads, bf16, 10 blocks, vocabulary 50,257,
    dropout 0.1), profiled statically by each package through its
    config's ``DataloaderGenerator`` probe (batch 32 x 128), gives equal
    memory, FLOPs within DEFAULT_RATIO per unit and, over the
    stimulator's draws with unbounded memory, one partition and one
    device order."""
    for key, value in (("SKYTPU_MODEL", "gpt"), ("SKYTPU_LAYER_NUM", "10"),
                       ("SKYTPU_PRESET", "large"), ("SKYTPU_SEQ_LEN", "128"),
                       ("SKYTPU_BATCH_SIZE", "32"),
                       ("SKYTPU_LOG_ROOT", str(tmp_path))):
        monkeypatch.setenv(key, value)
    monkeypatch.chdir(LAUNCH_CONFIG.parents[2])
    cfg = load_config(str(LAUNCH_CONFIG))
    ref_cfg = jax_load_config("experiment/config.py")
    units = cfg.model_config
    assert units == ref_cfg.model_config and len(units) == 22
    assert all(u["deterministic"] is False for u in units)
    assert units[0]["config"]["dropout_prob"] == 0.1
    flops, mem = ModelBenchmarker(
        units, DataloaderGenerator(cfg.data_config)).benchmark()
    ref_flops, ref_mem = JaxModelBench(
        units, JaxLoaderGen(ref_cfg.data_config)).benchmark()
    assert mem == ref_mem
    for kind, ratio in _ratio_by_type(units, flops, ref_flops).items():
        assert DEFAULT_RATIO[0] <= ratio <= DEFAULT_RATIO[1], (kind, ratio)
    unbounded = [float("inf")] * 4
    got = solve_contiguous_minmax(flops, mem, DRAWS, unbounded)
    ref = jax_solve_contiguous_minmax(ref_flops, ref_mem, DRAWS, unbounded)
    assert _partition(got) == _partition(ref)


def _zoo_stacks(case):
    """(port units, JAX units, port generator, JAX generator) of the
    stack that holds ``case``'s unit type."""
    from skycomputing_tpu.models import gpt as jgpt
    from skycomputing_tpu.models import resnet as jres
    from skycomputing_tpu.models.long_bert import (
        long_bert_layer_configs as jax_long,
    )
    from skycomputing_tpu_torch.models import gpt as tgpt
    from skycomputing_tpu_torch.models import long_bert_layer_configs
    from skycomputing_tpu_torch.models import resnet as tres

    if case.startswith("LongBertLayer_Head"):
        dtype = case.split("-")[1]

        def cfg(pkg_config):
            return pkg_config("tiny", dtype=dtype, hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.0,
                              max_position_embeddings=256)

        return (long_bert_layer_configs(cfg(bert_config), 2),
                jax_long(cfg(jax_bert_config), 2, None),
                RandomTokenGenerator(2, 256, 1024), JaxTokens(2, 256, 1024))
    if case == "GptBlock_MoeMlp":
        def units(pkg):
            cfg = pkg.GptConfig(vocab_size=512, hidden_size=64,
                                num_hidden_layers=4, num_attention_heads=2,
                                max_position_embeddings=64, dropout_prob=0.1,
                                dtype="float32")
            return pkg.gpt_layer_configs(cfg, moe_every=2, num_experts=4,
                                         moe_top_k=2)

        data_cfg = dict(dataset_cfg=dict(type="RandomLmDataset",
                                         num_samples=8, seq_length=64,
                                         vocab_size=512),
                        dataloader_cfg=dict(batch_size=4, shuffle=True))
        return (units(tgpt), units(jgpt), DataloaderGenerator(data_cfg),
                JaxLoaderGen(data_cfg))
    block = "BottleNeck" if case.endswith("BottleNeck") else "BasicBlock"
    return (tres.resnet_layer_configs(block, [1, 1, 1, 1]),
            jres.resnet_layer_configs(block, [1, 1, 1, 1]),
            RandomTensorGenerator(size=(4, 3, 32, 32)),
            JaxTensors(size=(4, 3, 32, 32)))


@pytest.mark.parametrize("case", [
    "LongBertLayer_Head-float32", "LongBertLayer_Head-bfloat16",
    "GptBlock_MoeMlp", "ResHead", "ResLayer-BasicBlock",
    "ResLayer-BottleNeck", "ResTail"])
def test_zoo_static_profile_and_partition_equal_jax(case):
    """Each unit type new to the zoo (long BERT's head, the MoE block and
    ResNet's units), in a stack that holds it (long BERT at L=256 with
    hidden dropout; MoE GPT with dropout; ResNet on CIFAR's 32 x 32
    images), profiled statically by each
    package: memory equal, every unit's FLOPs within DEFAULT_RATIO
    (convolutions without their padded taps, GroupNorm, the mean, the
    flash call's one grid cell and a bf16 pooler's convert, as XLA
    counts them), and over the stimulator's draws one partition and
    one device order."""
    units, ref_units, gen, ref_gen = _zoo_stacks(case)
    kind = case.split("-")[0]
    assert kind in [u["layer_type"] for u in units]
    flops, mem = ModelBenchmarker(units, gen).benchmark()
    ref_flops, ref_mem = JaxModelBench(ref_units, ref_gen).benchmark()
    assert mem == ref_mem
    for unit, got, ref in zip(units, flops, ref_flops):
        assert DEFAULT_RATIO[0] <= got / ref <= DEFAULT_RATIO[1], (
            unit["layer_type"], got / ref)
    unbounded = [float("inf")] * 4
    got = solve_contiguous_minmax(flops, mem, DRAWS, unbounded)
    ref = jax_solve_contiguous_minmax(ref_flops, ref_mem, DRAWS, unbounded)
    assert _partition(got) == _partition(ref)


def test_later_slices_raise_naming_them():
    """The mesh allocation that waited for a later slice is ported: on
    the same one-worker world both packages' ``mesh_allocate`` and
    ``refine_mesh_allocation`` leave the same allocation and chips."""
    states = []
    for manager_cls, alloc_cls in ((JaxWorkerManager, JaxAllocator),
                                   (WorkerManager, Allocator)):
        alloc, wm = _world(manager_cls, alloc_cls, [1.0], [10.0], [1.0],
                           [0.1], None)
        alloc.mesh_allocate()
        alloc.refine_mesh_allocation([1.0])
        states.append((_state(alloc, wm)[0], [
            w.extra_config.get("mesh_chips") for w in wm.worker_pool]))
    assert states[0] == states[1] and states[1][1] == [1]


# ------------------------------------------------- config, data, builders
def test_load_config_with_base_equals_jax(tmp_path):
    (tmp_path / "base.py").write_text(
        "import os\nLR = 0.1\nworkers = [dict(name='a'), dict(name='b')]\n"
        "train = dict(steps=3, optim='sgd')\n__hidden = 1\n"
        "class Skip:\n    pass\n")
    (tmp_path / "child.py").write_text(
        "base = 'base.py'\nLR = 0.5\nextra = (1, 2)\n")
    got = load_config(str(tmp_path / "child.py"))
    ref = jax_load_config(str(tmp_path / "child.py"))
    assert dict(got) == dict(ref)
    assert got.LR == 0.5 and got.train["steps"] == 3 and "base" not in got
    with pytest.raises(AttributeError):
        got.missing
    with pytest.raises(ValueError, match=".py"):
        load_config(str(tmp_path / "child.txt"))


def test_data_generators_and_bert_dataset_equal_jax():
    np.testing.assert_array_equal(
        RandomTensorGenerator(size=(3, 5), seed=2).generate(),
        JaxTensors(size=(3, 5), seed=2).generate())
    got, ref = RandomBertDataset(16, 24, 500, seed=3), JaxBert(16, 24, 500,
                                                               seed=3)
    for name in ("input_ids", "input_mask", "segment_ids", "labels"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.input_mask == 0).any()  # padded tails
    data_cfg = dict(dataset_cfg=dict(type="RandomBertDataset",
                                     num_samples=8, max_seq_length=12),
                    dataloader_cfg=dict(batch_size=4, shuffle=True))
    for fixed in (True, False):
        port = DataloaderGenerator(data_cfg, fixed=fixed)
        jax_gen = JaxLoaderGen(data_cfg, fixed=fixed)
        for _ in range(3):
            for a, b in zip(port.generate(), jax_gen.generate()):
                np.testing.assert_array_equal(a, b)
    gen = build_data_generator("RandomTokenGenerator",
                               dict(batch_size=2, seq_length=4))
    assert isinstance(gen, RandomTokenGenerator)
    loader = build_dataloader_from_cfg(data_cfg)
    assert len(loader) == 2


def test_build_factories(tmp_path):
    hook = build_hook(dict(type="StopHook", root=str(tmp_path)))
    assert isinstance(hook, StopHook)
    with pytest.raises(KeyError, match="hooks"):
        build_hook(dict(type="NoSuchHook"))
    stack = build_module_from_cfg(PROXY, rank=3)
    assert len(stack) == 1 and isinstance(stack[0], proxy_layers.MatmulStack)


if __name__ == "__main__":
    # The numbers behind FLOP_RATIO and the launcher's partition:
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_dynamics.py
    #   [--without-dropout-mask]   (the port's count before it counted
    #                               the dropout mask)
    import os
    import sys

    from skycomputing_tpu_torch.dynamics import estimator

    if "--without-dropout-mask" in sys.argv:
        del estimator._ELEMENT_FLOPS[torch.ops.aten.bernoulli_]
    for dropout in (False, True):
        for dtype in ("float32", "bfloat16"):
            for flash in (False, True):
                port_cfg = _cfgs(bert_config, bert_layer_configs, dtype,
                                 flash, dropout=dropout)
                flops, _ = ModelBenchmarker(
                    port_cfg, RandomTokenGenerator(2, 16, 1024)).benchmark()
                ref_flops, _ = JaxModelBench(
                    _cfgs(jax_bert_config, jax_bert_layers, dtype, flash,
                          dropout=dropout),
                    JaxTokens(2, 16, 1024)).benchmark()
                ratios = _ratio_by_type(port_cfg, flops, ref_flops)
                print(json.dumps(dict(
                    preset="tiny", dtype=dtype, flash=flash,
                    dropout=dropout,
                    ratios={k: round(v, 3) for k, v in ratios.items()})))
    os.environ.update(SKYTPU_LAYER_NUM="24", SKYTPU_FLASH="1",
                      SKYTPU_PRESET="large")
    units, (flops, mem), (ref_flops, ref_mem) = _launcher_profiles()
    unbounded = [float("inf")] * 4
    print(json.dumps(dict(
        preset="large", layers=24, dtype="bfloat16", flash=True,
        hidden_dropout=0.1,
        ratios={k: round(v, 3) for k, v in
                _ratio_by_type(units, flops, ref_flops).items()},
        port_partition=_partition(solve_contiguous_minmax(
            flops, mem, DRAWS, unbounded)),
        jax_partition=_partition(jax_solve_contiguous_minmax(
            ref_flops, ref_mem, DRAWS, unbounded)))))
