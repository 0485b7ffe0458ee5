"""The port's serving bench (``skycomputing_tpu_torch.bench_serving``)
against ``tools/bench_serving.py`` on the CPU.

The workload builders (``build_workload``, the ``interference`` mix,
``zero_tail_residuals``) give the JAX bench's specs and arrays for the
same seed; the slot-vs-paged A/B runner gives the JAX runner's streams,
concurrency samples and counters on the same weights; each section
runner at the bench's ``--smoke`` operating points has its mechanics
gates green and the JSON schema the JAX smoke tests read; and the
command exits 0 and writes that schema.
"""

import json

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models.gpt import GptConfig as JaxGptConfig
from skycomputing_tpu.models.gpt import gpt_layer_configs as jax_layer_cfgs
from skycomputing_tpu.workload.mixes import build_mix as jax_build_mix
from skycomputing_tpu_torch import bench_serving as bench
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.models.gpt import (
    GptConfig,
    gpt_layer_configs,
    random_state_dicts,
)
from skycomputing_tpu_torch.workload import MIXES, build_mix
from tools import bench_serving as jax_bench
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

SMOKE = bench.operating_points(smoke=True)
CPU = torch.device("cpu")


def _points(device=CPU):
    model, *ops = bench.operating_points(smoke=True)
    for op in ops:
        op.update(partition=None, device=device)
    return model, ops


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_build_workload_equals_jax(smoke, seed):
    """Every section's ``build_workload`` call, at both operating points,
    draws the JAX bench's specs."""
    _, bench_cfg, paged_cfg, _, spec_cfg, kernel_cfg = (
        bench.operating_points(smoke))
    for cfg, offset, span in (
            (bench_cfg, 0, bench_cfg["max_len"]),
            (paged_cfg, 1, paged_cfg["max_len"]),
            (spec_cfg, 3, spec_cfg["max_pages_per_request"]
             * spec_cfg["page_size"]),
            (kernel_cfg, 5, kernel_cfg["workload_span"])):
        args = (cfg["n_requests"], list(cfg["buckets"]), span, cfg["lo_new"],
                cfg["hi_new"])
        got = bench.build_workload(np.random.default_rng(seed + offset),
                                   *args)
        want = jax_bench.build_workload(np.random.default_rng(seed + offset),
                                        *args)
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smoke", [True, False])
def test_interference_mix_equals_jax(smoke):
    """The port's copy of the ``interference`` mix, by name and through
    the bench, draws the JAX mix's specs; an unknown name raises."""
    chunk_cfg = bench.operating_points(smoke)[3]
    want = jax_build_mix("interference", np.random.default_rng(2),
                         icfg=chunk_cfg)
    for got in (build_mix("interference", np.random.default_rng(2),
                          icfg=chunk_cfg),
                bench.build_interference_workload(np.random.default_rng(2),
                                                  chunk_cfg),
                jax_bench.build_interference_workload(
                    np.random.default_rng(2), chunk_cfg)):
        assert len(got) == len(want) == (chunk_cfg["n_churn"]
                                         + chunk_cfg["n_small"])
        for (a, n), (b, m) in zip(got, want):
            assert n == m
            np.testing.assert_array_equal(a, b)
    # the fleet bench's mixes sit beside it (test_torch_fleet_policy.py)
    assert sorted(MIXES) == ["fleet_bursty", "fleet_spike", "interference"]
    with pytest.raises(ValueError, match="unknown workload mix"):
        build_mix("bursty", np.random.default_rng(0))


@pytest.fixture(scope="module")
def jax_smoke_model():
    """The smoke model's JAX params and their port state dicts."""
    model = SMOKE[0]
    layer_cfgs = jax_layer_cfgs(JaxGptConfig(**model), deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(0),
                                        np.ones((1, 8), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs)


def test_zero_tail_residuals_equals_jax(jax_smoke_model):
    """The same blocks' residual projections zeroed (weight and bias),
    nothing else touched, the input left as it was."""
    layer_cfgs, params, sds = jax_smoke_model
    got = bench.zero_tail_residuals(layer_cfgs, sds, 1)
    want = params_from_jax(jax.device_get(
        jax_bench.zero_tail_residuals(layer_cfgs, params, 1)), layer_cfgs)
    zeroed = 0
    for g, w, orig in zip(got, want, sds):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key].numpy(), w[key].numpy())
            if not torch.equal(g[key], orig[key]):
                zeroed += 1
                assert key.startswith("c_proj.")
    assert zeroed == 2  # block 1: both c_proj weights (the biases are 0)
    assert any(float(sd["c_proj.weight"].abs().sum()) > 0
               for sd in sds if "c_proj.weight" in sd)


@pytest.mark.parametrize("paged", [False, True])
def test_concurrency_run_equals_jax(jax_smoke_model, paged):
    """The slot-vs-paged runner on the same weights: the port's streams,
    sustained and peak concurrency and scheduling counters are the JAX
    runner's."""
    layer_cfgs, params, sds = jax_smoke_model
    pcfg = dict(SMOKE[2], partition=None, pool_positions=144,
                kv_mb_per_position=2.0 * 64 * 4 / 1024.0 ** 2)
    specs = bench.build_workload(np.random.default_rng(1),
                                 pcfg["n_requests"], list(pcfg["buckets"]),
                                 pcfg["max_len"], pcfg["lo_new"],
                                 pcfg["hi_new"])
    got, g_outs, g_reqs = bench.run_concurrency_mode(
        layer_cfgs, sds, specs, paged, dict(pcfg, device=CPU))
    want, w_outs, w_reqs = jax_bench.run_concurrency_mode(
        layer_cfgs, params, specs, paged, pcfg)
    assert [g_outs[r.request_id].tolist() for r in g_reqs] == [
        w_outs[r.request_id].tolist() for r in w_reqs]
    for key in ("layout", "sustained_concurrency", "peak_concurrency",
                "steady_state_compiles", "pool_mb_per_stage_layer"):
        assert got[key] == want[key], key
    for key in ("iterations", "prefill_waves", "decode_tokens",
                "queue_stalls", "prefix_hits", "cow_copies"):
        assert got["stats"][key] == want["stats"][key], key


def _check_gates(section, expect):
    gates = section["gates"]
    assert sorted(gates) == sorted(expect)
    # smoke: no gate that judges a time
    assert not set(gates) & (bench.TIMING_GATES
                             - {"concurrency_gain_over_2x"})
    assert all(gates.values()), gates


def test_continuous_vs_static_section():
    model, (bench_cfg, *_) = _points()
    layer_cfgs = gpt_layer_configs(GptConfig(**model), deterministic=True)
    specs = bench.build_workload(
        np.random.default_rng(0), bench_cfg["n_requests"],
        list(bench_cfg["buckets"]), bench_cfg["max_len"],
        bench_cfg["lo_new"], bench_cfg["hi_new"])
    section = bench.continuous_vs_static(
        layer_cfgs, random_state_dicts(layer_cfgs, 0), specs, bench_cfg)
    _check_gates(section, ["token_identical"])
    assert section["static"]["policy"] == "static"
    assert section["continuous"]["stats"]["finished"] == len(specs) + 2
    assert section["throughput_speedup"] > 0


@pytest.mark.parametrize("name", ["paged", "chunked", "spec", "kernel"])
def test_section_smoke_gates_and_schema(name):
    """Each section at the ``--smoke`` operating points: mechanics gates
    green and the keys ``tests/test_serving.py``'s smoke tests read."""
    model, (_, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg) = _points()
    layer_cfgs = gpt_layer_configs(GptConfig(**model), deterministic=True)
    params = random_state_dicts(layer_cfgs, 0)
    if name == "paged":
        section = bench.paged_vs_slot(layer_cfgs, params, paged_cfg, 0, True)
        _check_gates(section, [
            "equal_pool_mb", "concurrency_gain_over_2x",
            "paged_token_identical", "paged_matches_slot",
            "zero_steady_state_recompiles", "prefix_hits_counted",
            "prefix_tokens_reused", "shared_token_identical"])
        assert section["concurrency_gain"] > 2.0
        assert section["operating_point"]["pool_mb_per_stage_layer"] == (
            pytest.approx(144 * 2 * 64 * 4 / 1024.0 ** 2))
        assert section["shared_prefix"]["prefix_hits"] >= 1
    elif name == "chunked":
        section = bench.chunked_backlog(layer_cfgs, params, chunk_cfg, 0,
                                        True)
        _check_gates(section, [
            "chunk_token_identical", "chunk_matches_unchunked",
            "zero_steady_state_recompiles", "chunks_counted"])
        assert section["chunked"]["itl_p95_s"] is not None
        assert section["chunked"]["prefill_chunks"] > 0
    elif name == "spec":
        section = bench.speculative(model, spec_cfg, 0, True)
        _check_gates(section, [
            "spec_token_identical", "spec_matches_plain",
            "zero_steady_state_recompiles", "drafts_counted"])
        assert section["draft_exact"] is True
        assert section["accept_rate"] == 1.0
    else:
        section = bench.kernel_quant(layer_cfgs, params, kernel_cfg, 0, True)
        _check_gates(section, [
            "live_token_identical", "live_matches_full_gather",
            "zero_steady_state_recompiles_live",
            "zero_steady_state_recompiles_int8",
            "pages_per_mb_gain_over_1_9x", "int8_agreement_over_0_7",
            "int8_first_token_over_0_9", "quant_counters_move"])
        assert section["pages_per_mb_gain"] >= 1.9
        assert section["int8"]["kv_dtype"] == "int8"
        assert section["live_gather"]["kv_dtype"] == "float32"
        assert section["full_gather"]["gather_pages"] == "full"
        assert section["live_gather"]["attn_impl"] == "plain"
        assert bench.kernel_leg(0, CPU) == {"skipped": "no CUDA device"}
        # on the CPU no kernel launches: the plain version serves
        assert all(n == 0 for by_body in section["int8"][
            "kernel_launches"].values() for n in by_body.values())
    assert section["identity_findings"] == []
    json.dumps(section)


@pytest.mark.parametrize("flags, keys", [
    ([], ["continuous", "static", "throughput_speedup", "token_identical"]),
    (["--kernel", "--stages", "2"], ["kernel_quant"]),
])
def test_command_smoke_exits_zero(tmp_path, flags, keys, capsys):
    """``python -m skycomputing_tpu_torch.bench_serving --smoke --device
    cpu`` in-process: exit 0, the artifact's schema, the kernel leg
    reported as skipped on the CPU; the default device is the card, so
    without one the command refuses to start."""
    out = tmp_path / "bench.json"
    rc = bench.main(["--smoke", "--device", "cpu", "--out", str(out)]
                    + flags)
    assert rc == 0
    assert "(PASS)" in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["smoke"] is True and report["device_kind"] == "cpu"
    assert "kernel libraries" in report["steady_state_compiles_counts"]
    for key in keys:
        assert key in report
    if "kernel_quant" in report:
        assert report["kernel_quant"]["kernel_leg"] == {
            "skipped": "no CUDA device"}
        assert report["serving"]["stages"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--smoke", "--out", str(out)])
