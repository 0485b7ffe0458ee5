"""Serving allocation port contracts on the CPU, against the JAX package:
the KV memory formulas, the slot decode step the profile counts, the
decode profile (``DecodeModelBenchmarker``), ``Allocator.serving_allocate``,
the serving pre-flight (``verify_plan(serving=...)``) and the knob
verifier (``verify_tuning_knobs``).

Memory charges must equal the reference's to the last digit (the
allocator and the verifier charge from one formula); costs must agree
per unit type within the ratios stated below; partitions, issue codes
and message text must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.analysis import plan_check as jpc
from skycomputing_tpu.builder import build_layer as jax_build_layer
from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import Estimator as JaxEstimator
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.serving import DecodeModelBenchmarker as JaxDecodeBench
from skycomputing_tpu.serving import kv_cache as jkv
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.analysis import plan_check as tpc
from skycomputing_tpu_torch.dynamics import Allocator, Estimator, WorkerManager
from skycomputing_tpu_torch.dynamics.benchmarker import _build_unit
from skycomputing_tpu_torch.serving import (
    DecodeModelBenchmarker,
    kv_mb_per_layer,
    paged_kv_mb_per_layer,
)
from skycomputing_tpu_torch.serving.kv_cache import KVCacheSpec

pytestmark = pytest.mark.torch_port


def _gpt_cfgs(preset="tiny", blocks=2):
    """The tests' tiny GPT (f32) or GPT-2 small (bf16, 12 blocks), as the
    JAX package builds its layer configs (the port reads the same
    dicts)."""
    if preset == "tiny":
        cfg = GptConfig(vocab_size=512, hidden_size=64,
                        num_hidden_layers=blocks, num_attention_heads=2,
                        max_position_embeddings=64, dropout_prob=0.0,
                        dtype="float32")
    else:
        cfg = GptConfig(dropout_prob=0.0)
    return gpt_layer_configs(cfg, deterministic=True)


# --- the KV memory formulas -------------------------------------------------


@pytest.mark.parametrize("slots, max_len, num_pages, page_size, kv_dtype", [
    (3, 48, 18, 8, None), (16, 512, 512, 16, None), (16, 512, 512, 16, "int8"),
    (7, 33, 5, 3, "int8"), (16, 512, 300, 32, "bfloat16"),
    (2, 64, 9, 7, "float32"),
])
def test_kv_mb_formulas_equal_jax(slots, max_len, num_pages, page_size,
                                  kv_dtype):
    """Per-layer slot and paged KV MB equal the reference's exactly, for
    the tiny GPT and GPT-2 small, fp and int8, odd geometries too."""
    for cfgs in (_gpt_cfgs(), _gpt_cfgs("gpt2")):
        assert kv_mb_per_layer(cfgs, slots, max_len) == \
            jkv.kv_mb_per_layer(cfgs, slots, max_len)
        got = paged_kv_mb_per_layer(cfgs, num_pages, page_size,
                                    kv_dtype=kv_dtype)
        assert got == jkv.paged_kv_mb_per_layer(cfgs, num_pages, page_size,
                                                kv_dtype=kv_dtype)
        assert got[0] == got[-1] == 0.0 and got[1] > 0.0
    spec = KVCacheSpec(max_len=max_len, num_heads=12, head_dim=64)
    ref = jkv.KVCacheSpec(max_len=max_len, num_heads=12, head_dim=64)
    assert spec.slab_shape(slots) == ref.slab_shape(slots)
    assert spec.slab_mb(slots) == ref.slab_mb(slots)


# --- the units' forward and slot decode -------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfgs = _gpt_cfgs()
    params = jax_build(cfgs).init(jax.random.key(3),
                                  np.ones((1, 5), np.int32))
    return cfgs, params, params_from_jax(jax.device_get(params), cfgs)


def _units(cfgs, sds, i):
    """Unit ``i`` in both packages, the port's holding the JAX weights."""
    cfg = dict(cfgs[i])
    layer_type = cfg.pop("layer_type")
    port = _build_unit(cfgs[i], "cpu")
    port.load_state_dict(sds[i])
    return port.eval(), jax_build_layer(layer_type, **cfg)


def test_forward_and_slot_decode_equal_jax(tiny):
    """The units' full-sequence forward (what the pre-flight threads) and
    the attention unit's slot ``decode`` (what the decode profile
    counts) equal the reference's, float32, within 1e-5: scalar and
    per-row index, positions clamped at the slab's end, the stale tail
    masked."""
    cfgs, params, sds = tiny
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, (3, 7)).astype(np.int32)
    emb, jemb = _units(cfgs, sds, 0)
    attn, jattn = _units(cfgs, sds, 1)
    p0 = {"params": params[0]}
    p1 = {"params": params[1]}
    hidden = emb(torch.from_numpy(ids))
    np.testing.assert_allclose(hidden.detach().numpy(),
                               np.asarray(jemb.apply(p0, ids)),
                               rtol=1e-5, atol=1e-5)
    h = hidden.detach().numpy()
    np.testing.assert_allclose(attn(hidden).detach().numpy(),
                               np.asarray(jattn.apply(p1, h)),
                               rtol=1e-5, atol=1e-5)
    slab = rng.standard_normal((3, 12, 2, 32)).astype(np.float32)
    new = rng.standard_normal((3, 2, 64)).astype(np.float32)
    for index in (np.int32(4), np.array([0, 5, 11], np.int32)):
        k, v = torch.from_numpy(slab.copy()), torch.from_numpy(slab * 0.5)
        out, k2, v2 = attn.decode(torch.from_numpy(new), k, v,
                                  torch.as_tensor(index))
        jout, jk, jv = jattn.apply(p1, new, slab.copy(), slab * 0.5, index,
                                   method=type(jattn).decode)
        for a, b in ((out, jout), (k2, jk), (v2, jv)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
        assert k2 is k and v2 is v  # written in place


# --- the decode profile -----------------------------------------------------

# port FLOPs / JAX FLOPs per unit type of the decode profile.  The
# products agree; the elementwise work is charged as XLA charges it on
# its CPU backend (dynamics/estimator.py), bf16 converts and the cast of
# the embedding table included.  The tiny float32 embeddings, a few
# hundred FLOPs, read lower: XLA also counts the position iota and
# broadcasts.
DECODE_RATIO = {
    ("tiny", "GptEmbeddings"): (0.25, 0.40),
}
DECODE_DEFAULT = (0.97, 1.03)

PROFILES = {
    "tiny-slot": ("tiny", dict(slots=3, max_len=48)),
    "tiny-slot-deep": ("tiny", dict(slots=16, max_len=64)),
    "tiny-paged": ("tiny", dict(slots=4, max_len=48, num_pages=20,
                                page_size=8)),
    "tiny-int8": ("tiny", dict(slots=4, max_len=48, num_pages=20,
                               page_size=8, kv_dtype="int8")),
    "gpt2-paged": ("gpt2", dict(slots=16, max_len=512, num_pages=512,
                                page_size=16)),
    "gpt2-int8": ("gpt2", dict(slots=16, max_len=512, num_pages=512,
                               page_size=16, kv_dtype="int8")),
}


@pytest.fixture(scope="module")
def profiles():
    """(port profile, JAX profile, operating points) per PROFILES key,
    computed once."""
    out = {}
    for name, (preset, kw) in PROFILES.items():
        cfgs = _gpt_cfgs(preset)
        port, ref = DecodeModelBenchmarker(cfgs, **kw), JaxDecodeBench(
            cfgs, **kw)
        out[name] = (cfgs, port.benchmark(), ref.benchmark(),
                     port.operating_point, ref.operating_point)
    return out


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_decode_profile_equals_jax(profiles, name):
    """Costs within the stated per-type ratios, memory equal within 1e-9
    relative (the formula plus the KV charge), operating point equal."""
    cfgs, (flops, mem), (ref_flops, ref_mem), point, ref_point = \
        profiles[name]
    preset = PROFILES[name][0]
    assert point == ref_point
    assert mem == pytest.approx(ref_mem, rel=1e-9)
    for unit, got, ref in zip(cfgs, flops, ref_flops):
        lo, hi = DECODE_RATIO.get((preset, unit["layer_type"]),
                                  DECODE_DEFAULT)
        assert lo <= got / ref <= hi, (unit["layer_type"], got / ref)


def test_decode_profile_charges_kv_slabs():
    """The reference's contract, replayed: slot-slab memory scales with
    the slot count, every cost is positive, the operating point is
    stamped; the profile is computed once."""
    cfgs = _gpt_cfgs()
    small = DecodeModelBenchmarker(cfgs, slots=2, max_len=32)
    big = DecodeModelBenchmarker(cfgs, slots=8, max_len=32)
    costs_s, mems_s = small.benchmark()
    _, mems_b = big.benchmark()
    assert len(costs_s) == len(cfgs) and all(c > 0 for c in costs_s)
    for cfg, ms, mb in zip(cfgs, mems_s, mems_b):
        if cfg["layer_type"] == "GptBlock_Attn":
            assert mb > ms
    assert small.operating_point == dict(slots=2, max_len=32)
    assert small.benchmark() is small.benchmark()


@pytest.mark.parametrize("kwargs", [
    dict(slots=0, max_len=8), dict(slots=2, max_len=0),
    dict(slots=2, max_len=8, num_pages=4),
    dict(slots=2, max_len=8, page_size=4),
    dict(slots=2, max_len=8, num_pages=0, page_size=4),
    dict(slots=2, max_len=8, kv_dtype="int8"),
], ids=["slots", "max_len", "pages-alone", "page-size-alone", "zero-pages",
        "int8-slot"])
def test_decode_profile_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError) as got:
        DecodeModelBenchmarker(_gpt_cfgs(), **kwargs)
    with pytest.raises(ValueError) as want:
        JaxDecodeBench(_gpt_cfgs(), **kwargs)
    assert str(got.value) == str(want.value)


def test_benchmark_decode_step_charges_data_outputs_only():
    """An attention decode returns its slabs beside the hidden state;
    they are the inputs written in place, so ``mem_MB`` counts the
    hidden state alone and equals the reference's; the slab shapes come
    back unchanged."""
    cfgs = _gpt_cfgs()
    S, M = 4, 32
    hidden = torch.empty((S, 1, 64), device="meta")
    slab = torch.empty((S, M, 2, 32), device="meta")
    index = torch.empty((S,), dtype=torch.int32, device="meta")
    out, flops, mem = Estimator.benchmark_decode_step(
        _build_unit(cfgs[1], "meta"), (hidden,), cache_avals=(slab, slab),
        index=index)
    assert [tuple(o.shape) for o in out] == [(S, 1, 64), (S, M, 2, 32),
                                             (S, M, 2, 32)]
    jslab = jax.ShapeDtypeStruct((S, M, 2, 32), np.float32)
    cfg = dict(cfgs[1])
    jout, jflops, jmem = JaxEstimator.benchmark_decode_step(
        jax_build_layer(cfg.pop("layer_type"), **cfg),
        (jax.ShapeDtypeStruct((S, 1, 64), np.float32),),
        cache_avals=(jslab, jslab),
        index=jax.ShapeDtypeStruct((S,), np.int32))
    assert mem == jmem
    with_slabs = mem + 2 * 2 * S * M * 64 * 4 / 1024.0 ** 2
    assert mem < with_slabs
    assert 0.97 <= flops / jflops <= 1.03


# --- serving_allocate ------------------------------------------------------


class _Devices:
    """Device profiles keyed by current rank, looked up by stable
    stim_index (what the real benchmarker does after a re-rank)."""

    def __init__(self, times, mems, wm):
        self._times, self._mems, self._wm = times, mems, wm

    def benchmark(self):
        return {f"worker{w.rank}": dict(time=self._times[w.stim_index],
                                        avai_mem=self._mems[w.stim_index])
                for w in self._wm.worker_pool}


class _Profile:
    def __init__(self, flops, mems):
        self._result = (list(flops), list(mems))

    def benchmark(self):
        return self._result


def _workers(manager_cls, n):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i),
             extra_config=dict(mem_limit=-1, slowdown=1.0))
        for i in range(n)
    ])
    return wm


def _partition(wm):
    """(slice lengths, their workers' stable names) in rank order."""
    stages = sorted((w for w in wm.worker_pool if w.model_config),
                    key=lambda w: w.rank)
    return [len(w.model_config) for w in stages], [w.name for w in stages]


def _serving_allocate(pkg, cfgs, decode, times, mems):
    """Both packages' ``serving_allocate`` over one profile per package
    and injected device times and memory; the training override set
    beforehand must survive."""
    manager, alloc_cls = ((WorkerManager, Allocator) if pkg == "port"
                          else (JaxWorkerManager, JaxAllocator))
    wm = _workers(manager, len(times))
    training = _Profile([1.0] * len(cfgs), [0.1] * len(cfgs))
    alloc = alloc_cls(cfgs, wm, training, _Devices(times, mems, wm))
    alloc._cost_override = [2.0] * len(cfgs)  # a training calibration
    alloc.serving_allocate(decode, max_time=5)
    assert alloc._cost_override == [2.0] * len(cfgs)
    assert alloc._model_benchmarker is training
    return _partition(wm)


INJECTED = {
    # name -> (per-unit decode costs, per-unit MB, device times, device MB)
    "attention-heavy": ([5.0] + [9.0, 2.0] * 6 + [30.0],
                        [3.0] + [2.0, 0.5] * 6 + [3.0],
                        [1.0, 2.0, 1.5], [1e9] * 3),
    "memory-binds": ([5.0] + [9.0, 2.0] * 6 + [30.0],
                     [3.0] + [2.0, 0.5] * 6 + [3.0],
                     [1.0, 1.0, 1.0, 1.0], [6.0, 9.0, 4.0, 9.0]),
    "slow-node": ([1.0] + [4.0, 4.0] * 6 + [8.0], [1.0] * 14,
                  [1.0, 5.0, 1.0, 1.0], [1e9] * 4),
}


@pytest.mark.parametrize("name", sorted(INJECTED))
def test_serving_allocate_equals_jax_on_injected_profiles(name):
    """On injected decode profiles and devices, the same partition on the
    same workers; the training profiler and its cost override are
    restored after the solve."""
    flops, mems, times, dev_mem = INJECTED[name]
    cfgs = [dict(layer_type="Dense", features=8, unit=i)
            for i in range(len(flops))]
    got = _serving_allocate("port", cfgs, _Profile(flops, mems), times,
                            dev_mem)
    assert got == _serving_allocate("jax", cfgs, _Profile(flops, mems),
                                    times, dev_mem)
    assert sum(got[0]) == len(cfgs)


DRAWS = (3.32, 2.32, 3.58, 3.09)  # the stimulator's draws at 4 workers
PAPER = (3.0, 5.0, 3.0, 6.0)  # the headline pass's slowdowns


@pytest.mark.parametrize("times", [DRAWS, PAPER], ids=["draws", "paper"])
@pytest.mark.parametrize("budget", [(450.0,) * 4, (400.0, 500.0, 450.0,
                                                  600.0)],
                         ids=["even-budget", "uneven-budget"])
@pytest.mark.parametrize("name", ["gpt2-paged", "gpt2-int8"])
def test_serving_allocate_gpt2_small_equals_jax(profiles, name, times,
                                                budget):
    """GPT-2 small's 26 units at its serving operating point (16 rows,
    512-token span, 512 pages of 16, fp or int8), profiled statically by
    each package and solved by ``serving_allocate`` over four injected
    device speeds and budgets that bind (the units' need is 1,542 MB
    fp / 1,398 MB int8): one partition on the same workers."""
    cfgs, (flops, mem), (ref_flops, ref_mem), _, _ = profiles[name]
    got = _serving_allocate("port", cfgs, _Profile(flops, mem), times,
                            budget)
    assert got == _serving_allocate("jax", cfgs, _Profile(ref_flops,
                                                          ref_mem),
                                    times, budget)
    assert sum(got[0]) == 26 and len(got[0]) == 4


# --- the serving pre-flight -------------------------------------------------


def _staged(manager_cls, cfgs, counts, limit):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"n{i}", device_config=dict(device_index=i),
             extra_config=dict(mem_limit=limit))
        for i in range(len(counts))
    ])
    cursor = 0
    for w, c in zip(wm.worker_pool, counts):
        w.model_config = cfgs[cursor:cursor + c]
        w.order = w.rank + 1
        cursor += c
    return wm


def _issues(report):
    return [(i.code, i.severity, i.message) for i in report.issues]


N_UNITS = 6  # the tiny GPT's units (2 blocks)
SERVING = {
    "slot-fits": (1000.0, dict(slots=4, max_len=32, bucket=16)),
    # the reference's test_engine_preflight_rejects_over_budget_kv_slabs
    "slot-over-budget": (0.05, dict(slots=64, max_len=64, bucket=8)),
    "paged-over-budget": (0.3, dict(num_pages=64, page_size=8,
                                    max_pages_per_request=6, bucket=16)),
    "int8-over-budget": (0.3, dict(num_pages=64, page_size=8,
                                   max_pages_per_request=6, bucket=16,
                                   kv_dtype="int8")),
    "int8-fits": (1000.0, dict(num_pages=64, page_size=8, kv_dtype="int8")),
    "explicit-kv": (1.5, dict(slots=32, max_len=128, bucket=64,
                              kv_mb_per_layer=[1.0] * N_UNITS)),
    "draft-mb": (1.5, dict(slots=1, max_len=4, draft_mb=50.0,
                           kv_mb_per_layer=[0.0] * N_UNITS)),
    "draft-mb-junk": (1.5, dict(slots=1, max_len=4, draft_mb="big",
                                kv_mb_per_layer=[0.0] * N_UNITS)),
    "kv-wrong-length": (1000.0, dict(slots=4, max_len=32,
                                     kv_mb_per_layer=[1.0, 2.0])),
    "kv-not-a-list": (1000.0, dict(slots=4, max_len=32, kv_mb_per_layer=7)),
    "kv-not-numbers": (1000.0, dict(slots=4, max_len=32,
                                    kv_mb_per_layer=["a"] * N_UNITS)),
    "junk-bucket": (0.5, dict(slots=4, max_len=32, bucket="x",
                              kv_mb_per_layer=[1.0] * N_UNITS)),
    "no-shape-keys": (1000.0, dict(bucket=16)),
    "int8-on-slots": (1000.0, dict(slots=4, max_len=32, kv_dtype="int8")),
    "unknown-kv-dtype": (1000.0, dict(num_pages=8, page_size=8,
                                      kv_dtype="int4")),
    "paged-missing-size": (1000.0, dict(num_pages=8)),
}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_verify_plan_serving_equals_jax(name):
    """The same plan under the same serving context: equal checks and
    equal (code, severity, message) lists — slot and paged contexts,
    ``kv_dtype``, an explicit ``kv_mb_per_layer``, ``draft_mb`` on stage
    0, and every malformed context degrading to a diagnostic."""
    limit, serving = SERVING[name]
    cfgs = _gpt_cfgs()
    ids = (np.zeros((4, 1), np.int32),)
    got = tpc.verify_plan(cfgs, _staged(WorkerManager, cfgs, [3, 3], limit),
                          ids, memory="error", check_donation=False,
                          serving=dict(serving))
    want = jpc.verify_plan(cfgs, _staged(JaxWorkerManager, cfgs, [3, 3],
                                         limit),
                           ids, memory="error", check_donation=False,
                           serving=dict(serving))
    assert got.checks == want.checks
    assert _issues(got) == _issues(want)
    assert got.ok == name.endswith("fits")
    if name.endswith("over-budget"):
        label = ("KV slots" if "slots" in serving else "KV pages")
        assert label in got.errors[0].message


@pytest.mark.parametrize("knobs", [
    dict(schedule="1f1b", num_microbatches=4, batch_size=8),
    dict(schedule="steady"), dict(num_microbatches=3, batch_size=8),
    dict(buckets=(8, 16), max_len=32, num_slots=4),
    dict(buckets=(8, 64), max_len=32), dict(buckets=(), max_len=32),
    dict(num_slots=-1), dict(buckets=[None, 64]), dict(buckets=["a", 2.5]),
    dict(buckets=(8, 16), max_len=32, prefill_chunk=8, spec_k=2),
    dict(buckets=(8, 16), max_len=32, prefill_chunk=12),
    dict(prefill_chunk=0), dict(spec_k=-1), dict(spec_k=True),
    dict(max_len=4, spec_k=6),
    dict(num_pages=12, page_size=8, max_pages_per_request=100),
    dict(buckets=(8, 16), page_size=4, max_pages_per_request=3),
], ids=lambda k: "-".join(sorted(k)))
def test_verify_tuning_knobs_equals_jax(knobs):
    got = tpc.verify_tuning_knobs(**knobs)
    want = jpc.verify_tuning_knobs(**knobs)
    assert got.checks == want.checks == ["knobs"]
    assert _issues(got) == _issues(want)


if __name__ == "__main__":
    # The numbers behind DECODE_RATIO and fault C3 (ROADMAP.md):
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_serving_alloc.py
    #   [--parent-counter]   (the counter before it charged XLA's bf16
    #                         converts, the embedding table cast and
    #                         erf-gelu, and while it counted einsum's
    #                         layout copies)
    # Per unit type, port FLOPs / JAX FLOPs of the decode profile; then,
    # at GPT-2 small's operating point, how many of 41 device-speed draws
    # x 6 budget sets give both packages one partition.
    import json
    import sys

    from skycomputing_tpu.dynamics.solver import (
        solve_contiguous_minmax as jax_solve,
    )
    from skycomputing_tpu_torch.dynamics import estimator
    from skycomputing_tpu_torch.dynamics.solver import (
        solve_contiguous_minmax,
    )

    if "--parent-counter" in sys.argv:
        from torch.utils._pytree import tree_leaves

        def parent_dispatch(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            per = estimator._ELEMENT_FLOPS.get(func.overloadpacket)
            if per is None and torch.Tag.pointwise in func.tags:
                per = 1
            first = next((t for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)
                          and t.is_floating_point()), None)
            if per and first is not None:
                self.flops += per * first.numel()
            return out

        for op in (torch.ops.aten.clone, torch.ops.aten.gelu):
            del estimator._ELEMENT_FLOPS[op]
        estimator._ElementwiseFlops.__torch_dispatch__ = parent_dispatch
    for name, (preset, kw) in sorted(PROFILES.items()):
        cfgs = _gpt_cfgs(preset)
        flops, _ = DecodeModelBenchmarker(cfgs, **kw).benchmark()
        ref, _ = JaxDecodeBench(cfgs, **kw).benchmark()
        ratios = {}
        for unit, got, want in zip(cfgs, flops, ref):
            ratios.setdefault(unit["layer_type"], round(got / want, 4))
        print(json.dumps(dict(profile=name, ratios=ratios)))
    rng = np.random.default_rng(0)
    draws = [DRAWS] + [tuple(rng.uniform(1, 6, 4).round(2))
                       for _ in range(40)]
    budgets = [(float("inf"),) * 4, (450.0,) * 4, (400.0, 500.0, 450.0,
                                                    600.0),
               (700.0, 400.0, 400.0, 700.0), (600.0,) * 4, (400.0,) * 4]
    for name in ("gpt2-paged", "gpt2-int8"):
        cfgs = _gpt_cfgs("gpt2")
        kw = PROFILES[name][1]
        flops, mem = DecodeModelBenchmarker(cfgs, **kw).benchmark()
        ref, ref_mem = JaxDecodeBench(cfgs, **kw).benchmark()
        same = total = 0
        for times in draws:
            for budget in budgets:
                a = solve_contiguous_minmax(flops, mem, list(times),
                                            list(budget))
                b = jax_solve(ref, ref_mem, list(times), list(budget))
                total += 1
                same += (a.as_ranges(4), a.device_order) == (
                    b.as_ranges(4), b.device_order)
        print(json.dumps(dict(profile=name, equal_partitions=same,
                              cases=total)))
