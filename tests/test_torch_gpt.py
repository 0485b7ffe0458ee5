"""GPT decode-unit port contracts: each port module, and a whole paged
prefill + decode step, against the JAX modules on the same weights
(moved with ``params_from_jax``), in float32 at 1e-5 relative — over fp
page slabs and over int8 ``QuantizedPages`` slabs — plus the
speculative draft's layer slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models import gpt as jgpt
from skycomputing_tpu_torch import (
    LAYER,
    LayerStack,
    build_layer_stack,
    params_from_jax,
)
from skycomputing_tpu_torch.models import gpt as tgpt
from skycomputing_tpu.serving import kv_cache as jkv
from skycomputing_tpu_torch.serving import kv_cache as tkv
from skycomputing_tpu_torch.serving.kv_cache import paged_write_plan, write_plan

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-5, 1e-6
P, PS = 12, 4


@pytest.fixture(scope="module")
def tiny():
    """Tiny GPT in both packages on the same weights."""
    cfg = jgpt.GptConfig(vocab_size=512, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=64, dropout_prob=0.0,
                         dtype="float32")
    layer_cfgs = jgpt.gpt_layer_configs(cfg, deterministic=True)
    jstack = jax_build(layer_cfgs)
    params = jax.device_get(
        jstack.init(jax.random.key(3), np.ones((1, 5), np.int32)))
    tstack = build_layer_stack(layer_cfgs)
    for module, sd in zip(tstack.layers, params_from_jax(params,
                                                         layer_cfgs)):
        module.load_state_dict(sd, strict=True)
    return layer_cfgs, jstack.modules, params, tgpt.decode_modules(tstack)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_layer_configs_and_registry_match_jax(tiny):
    layer_cfgs, _, _, tmods = tiny
    port_cfgs = tgpt.gpt_layer_configs(
        tgpt.GptConfig.from_dict(layer_cfgs[0]["config"]),
        deterministic=True)
    assert port_cfgs == layer_cfgs
    assert [type(m).__name__ for m in tmods] == [
        c["layer_type"] for c in layer_cfgs]
    assert tgpt.attn_indices(tmods) == [1, 3]


def test_embeddings_decode_matches_jax(tiny):
    _, jmods, params, tmods = tiny
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (3, 5)).astype(np.int32)
    index = np.array([0, 7, 30], np.int32)
    ref = jmods[0].apply({"params": params[0]}, ids, index,
                         method=jgpt.GptEmbeddings.decode)
    _close(tmods[0].decode(torch.from_numpy(ids), torch.from_numpy(index))
           .detach(), ref)


@pytest.mark.parametrize("layer", [2, 5], ids=["mlp", "lm_head"])
def test_mlp_and_head_match_jax(tiny, layer):
    _, jmods, params, tmods = tiny
    rng = np.random.default_rng(layer)
    hidden = rng.standard_normal((2, 6, 64)).astype(np.float32)
    ref = jmods[layer].apply({"params": params[layer]}, hidden)
    out = tmods[layer](torch.from_numpy(hidden)).detach()
    assert out.dtype == torch.float32
    _close(out, ref)


def _paged_inputs(seed, R, Lq):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, PS, 2, 32)).astype(np.float32)
    v = rng.standard_normal((P, PS, 2, 32)).astype(np.float32)
    table = np.full((R, 4), P, np.int32)
    table[0, :3] = [5, 2, 9]
    if R > 1:
        table[1, :2] = [0, 7]
    index = np.array([5, 2, 0][:R], np.int32)
    valid = index + Lq
    if R > 2:
        valid[2] = 0  # an all-pad row
    return k, v, table, index, valid


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_attn_decode_paged_matches_jax(tiny, impl):
    """One attention unit: same hidden output and same slabs as JAX's
    ``decode_paged`` under either attention body."""
    _, jmods, params, tmods = tiny
    R, Lq = 3, 3
    k, v, table, index, valid = _paged_inputs(1, R, Lq)
    hidden = np.random.default_rng(2).standard_normal(
        (R, Lq, 64)).astype(np.float32)
    jh, jk, jv = jmods[1].apply(
        {"params": params[1]}, hidden, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(index), jnp.asarray(valid), impl,
        method=jgpt.GptBlock_Attn.decode_paged)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    plan = paged_write_plan(table, index, valid, P, PS, Lq)
    with torch.no_grad():
        th, _, _ = tmods[1].decode_paged(
            torch.from_numpy(hidden), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index), plan)
    # row 2 is a pad row: its output is discarded garbage, on which the
    # XLA body (flat-clipped sentinels) and the kernels (clamped page)
    # legitimately differ
    live = valid > 0
    _close(th.numpy()[live], np.asarray(jh)[live])
    _close(tk, jk)  # the written K/V are projections: float32 roundoff
    _close(tv, jv)


def test_apply_kv_paged_prefill_then_decode_matches_jax(tiny):
    """The whole stack: a prefill wave (shared-prefix row + fresh row +
    pad row) then a decode step with an inactive row, logits and every
    layer's slabs equal to JAX's ``apply_kv_paged``."""
    _, jmods, params, tmods = tiny
    rng = np.random.default_rng(4)
    shape = (P, PS, 2, 32)
    slabs_np = [(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
                for _ in range(2)]
    jslabs = [(jnp.asarray(a), jnp.asarray(b)) for a, b in slabs_np]
    tslabs = [(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
              for a, b in slabs_np]
    table = np.full((3, 4), P, np.int32)
    table[0, :3] = [5, 2, 9]
    table[1, :2] = [0, 7]
    steps = [
        # prefill: Lq = 8 bucket, row 1 is 6 tokens + 2 pad, row 2 pad
        (rng.integers(1, 512, (3, 8)), [0, 0, 0], [8, 6, 0]),
        # decode: rows 0, 1 advance one token; row 2 inactive
        (rng.integers(1, 512, (3, 1)), [8, 6, 0], [9, 7, 0]),
    ]
    for ids, index, valid in steps:
        ids = ids.astype(np.int32)
        index = np.asarray(index, np.int32)
        valid = np.asarray(valid, np.int32)
        jout, jslabs = jgpt.apply_kv_paged(
            jmods, params, jnp.asarray(ids), jslabs, jnp.asarray(table),
            jnp.asarray(index), jnp.asarray(valid), attn_impl="xla")
        tout, tslabs = tgpt.apply_kv_paged(
            tmods, torch.from_numpy(ids), tslabs, table, index, valid)
        live = valid > 0
        _close(tout.numpy()[live], np.asarray(jout)[live])
        for (tk, tv), (jk, jv) in zip(tslabs, jslabs):
            _close(tk, jk)
            _close(tv, jv)


def test_params_from_jax_layouts_and_errors(tiny):
    layer_cfgs, _, params, _ = tiny
    sds = params_from_jax(params, layer_cfgs)
    kern = np.asarray(params[1]["q_proj"]["kernel"])
    np.testing.assert_array_equal(sds[1]["q_proj.weight"].numpy(), kern.T)
    np.testing.assert_array_equal(
        sds[0]["wte.weight"].numpy(), np.asarray(params[0]["wte"]["embedding"]))
    np.testing.assert_array_equal(
        sds[-1]["ln_f.weight"].numpy(), np.asarray(params[-1]["ln_f"]["scale"]))
    with pytest.raises(ValueError, match="param trees"):
        params_from_jax(params[:-1], layer_cfgs)
    with pytest.raises(ValueError, match="expected"):
        params_from_jax([params[2]] + list(params[1:]), layer_cfgs)


def test_random_state_dicts_are_seeded_and_load_strictly(tiny):
    layer_cfgs, _, _, _ = tiny
    a = tgpt.random_state_dicts(layer_cfgs, seed=5)
    b = tgpt.random_state_dicts(layer_cfgs, seed=5)
    stack = build_layer_stack(layer_cfgs)
    for module, sd, sd2 in zip(stack.layers, a, b):
        module.load_state_dict(sd, strict=True)
        for key in sd:
            assert torch.equal(sd[key], sd2[key])
    assert float(a[1]["ln_1.weight"].mean()) == 1.0
    assert abs(float(a[0]["wte.weight"].std()) - 0.02) < 2e-3


def test_registry_fallback_and_tuple_threading_stack():
    """Configs may name ``torch.nn`` layers directly; the stack threads
    outputs as tuples and slices into a stack."""
    assert LAYER.get_module("Linear") is torch.nn.Linear
    assert "GptBlock_Attn" in LAYER and "NoSuchLayer" not in LAYER
    stack = build_layer_stack([
        dict(layer_type="Linear", in_features=4, out_features=3),
        dict(layer_type="GELU"),
        dict(layer_type="Linear", in_features=3, out_features=2),
    ])
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32))
    out = stack(x)
    head = stack[:2]
    assert isinstance(head, LayerStack) and len(head) == 2
    np.testing.assert_allclose(stack.layers[2](head(x)).detach().numpy(),
                               out.detach().numpy())
    with pytest.raises(ValueError, match="ring attention"):
        tgpt.decode_modules([tgpt.GptBlock_Attn(
            tgpt.GptConfig(hidden_size=8, num_attention_heads=2), mesh="sp")])


def _int8_slabs(seed, n_layers):
    """Random int8 page slabs (values and scales) as (torch, jax)
    QuantizedPages pairs holding the same numbers."""
    rng = np.random.default_rng(seed)
    out_t, out_j = [], []
    for _ in range(n_layers):
        pair_t, pair_j = [], []
        for _ in range(2):
            vals = rng.integers(-127, 128, (P, PS, 2, 32)).astype(np.int8)
            scale = rng.uniform(0.005, 0.03, (P, 2)).astype(np.float32)
            pair_t.append(tkv.QuantizedPages(torch.from_numpy(vals.copy()),
                                             torch.from_numpy(scale.copy())))
            pair_j.append(jkv.QuantizedPages(jnp.asarray(vals),
                                             jnp.asarray(scale)))
        out_t.append(tuple(pair_t))
        out_j.append(tuple(pair_j))
    return out_t, out_j


def _close_int8(tslab, jslab):
    """The written K/V are projections (float32 roundoff between the two
    packages), so a value sitting on a rounding boundary may land one
    int8 step apart; anything more is a fault.  Scales are amax / 127 of
    those projections: 1e-5 relative."""
    diff = np.abs(tslab.values.numpy().astype(np.int32)
                  - np.asarray(jslab.values).astype(np.int32))
    assert diff.max() <= 1, f"int8 values differ by {diff.max()} steps"
    assert (diff > 0).mean() < 1e-3, f"{int((diff > 0).sum())} values differ"
    _close(tslab.scale, jslab.scale)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_attn_decode_paged_int8_matches_jax(tiny, impl):
    """One attention unit over int8 pages (kernel B3's path): the same
    hidden output and the same re-quantized pages as JAX's
    ``decode_paged`` under either attention body."""
    _, jmods, params, tmods = tiny
    R, Lq = 3, 3
    _, _, table, index, valid = _paged_inputs(5, R, Lq)
    (tpair,), (jpair,) = _int8_slabs(6, 1)
    hidden = np.random.default_rng(7).standard_normal(
        (R, Lq, 64)).astype(np.float32)
    jh, jk, jv = jmods[1].apply(
        {"params": params[1]}, hidden, *jpair, jnp.asarray(table),
        jnp.asarray(index), jnp.asarray(valid), impl,
        method=jgpt.GptBlock_Attn.decode_paged)
    plan = write_plan(tpair[0], table, index, valid, Lq)
    assert isinstance(plan, tkv.QuantizedWrite)
    with torch.no_grad():
        th, tk, tv = tmods[1].decode_paged(
            torch.from_numpy(hidden), *tpair, torch.from_numpy(table),
            torch.from_numpy(index), plan)
    assert tk is tpair[0] and tv is tpair[1]  # written in place
    live = valid > 0
    _close(th.numpy()[live], np.asarray(jh)[live])
    _close_int8(tk, jk)
    _close_int8(tv, jv)


def test_apply_kv_paged_int8_prefill_then_decode_matches_jax(tiny):
    """The whole stack over int8 pools: a prefill wave then a decode
    step, logits and every layer's pages as JAX's ``apply_kv_paged``
    with ``QuantizedPages`` slabs."""
    _, jmods, params, tmods = tiny
    rng = np.random.default_rng(8)
    tslabs, jslabs = _int8_slabs(9, 2)
    table = np.full((3, 4), P, np.int32)
    table[0, :3] = [5, 2, 9]
    table[1, :2] = [0, 7]
    steps = [(rng.integers(1, 512, (3, 8)), [0, 0, 0], [8, 6, 0]),
             (rng.integers(1, 512, (3, 1)), [8, 6, 0], [9, 7, 0])]
    for ids, index, valid in steps:
        ids = ids.astype(np.int32)
        index = np.asarray(index, np.int32)
        valid = np.asarray(valid, np.int32)
        jout, jslabs = jgpt.apply_kv_paged(
            jmods, params, jnp.asarray(ids), jslabs, jnp.asarray(table),
            jnp.asarray(index), jnp.asarray(valid), attn_impl="pallas")
        tout, tslabs = tgpt.apply_kv_paged(
            tmods, torch.from_numpy(ids), tslabs, table, index, valid)
        live = valid > 0
        _close(tout.numpy()[live], np.asarray(jout)[live])
        for (tk, tv), (jk, jv) in zip(tslabs, jslabs):
            _close_int8(tk, jk)
            _close_int8(tv, jv)


def test_draft_slice_indices_match_jax(tiny):
    """The speculative draft's prefix slice: embeddings + the first
    ``draft_blocks`` blocks + the LM head, the same indices as JAX; a
    draft as deep as the target, or of no block, is refused."""
    _, jmods, _, tmods = tiny
    assert tgpt.draft_slice_indices(tmods, 1) == \
        jgpt.draft_slice_indices(jmods, 1) == [0, 1, 2, 5]
    for blocks in (0, 2):
        with pytest.raises(ValueError, match="draft_blocks"):
            tgpt.draft_slice_indices(tmods, blocks)
    with pytest.raises(ValueError, match="GPT stack"):
        tgpt.draft_slice_indices(tmods[1:], 1)


# --- ring attention (a mesh) --------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
def test_gpt_ring_attention_matches_dense(tiny, devices, S):
    """``GptBlock_Attn(mesh=...)``: the stack with causal ring attention
    over S CPU positions gives the dense stack's logits on the same
    weights (rtol 3e-4 / atol 3e-5, ``tests/test_gpt.py``'s bound) and
    JAX's ring stack's over its first S devices (1e-5)."""
    from jax.sharding import Mesh as JaxMesh

    from skycomputing_tpu_torch.parallel.mesh import make_1d_mesh

    layer_cfgs, _, params, tmods = tiny
    gcfg = tgpt.GptConfig.from_dict(layer_cfgs[0]["config"])
    ring_cfgs = tgpt.gpt_layer_configs(
        gcfg, deterministic=True,
        mesh=make_1d_mesh(S, "sp", [torch.device("cpu")] * S))
    ring = build_layer_stack(ring_cfgs)
    for module, sd in zip(ring.layers, params_from_jax(params, layer_cfgs)):
        module.load_state_dict(sd, strict=True)
    ids = np.random.default_rng(S).integers(0, 512, (2, 64)).astype(
        np.int32)
    with torch.no_grad():
        out = ring(torch.from_numpy(ids)).numpy()
        dense = LayerStack(tmods)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, dense, rtol=3e-4, atol=3e-5)
    jring = jax_build(jgpt.gpt_layer_configs(
        jgpt.GptConfig.from_dict(layer_cfgs[0]["config"]),
        deterministic=True, mesh=JaxMesh(np.array(devices[:S]), ("sp",))))
    ref = np.asarray(jax.jit(jring.apply)(params, ids))
    _close(out, ref)


def test_decode_rejects_a_mesh_as_jax(tiny, devices):
    """Cached decoding has no ring form: a block built with a mesh is
    refused with JAX's message."""
    from jax.sharding import Mesh as JaxMesh

    from skycomputing_tpu_torch.parallel.mesh import make_1d_mesh

    layer_cfgs, _, _, _ = tiny
    cfg = layer_cfgs[1]["config"]
    with pytest.raises(ValueError, match="ring attention") as jax_err:
        jgpt.decode_modules([jgpt.GptBlock_Attn(
            jgpt.GptConfig.from_dict(cfg),
            mesh=JaxMesh(np.array(devices[:2]), ("sp",)))])
    with pytest.raises(ValueError, match="ring attention") as err:
        tgpt.decode_modules([tgpt.GptBlock_Attn(
            cfg, mesh=make_1d_mesh(2, "sp", ["cpu"] * 2))])
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_gpt_mesh_block_static_profile_equals_jax(devices, S):
    """The static profile of a stack whose attention blocks are built
    with a mesh (fault C8): on ``meta`` each block runs one position's
    program, as XLA counts one device's share of JAX's ``shard_map``'d
    ring (its ``scan`` body once), so every unit's FLOPs lie within
    ``tests/test_torch_dynamics.py``'s DEFAULT_RATIO of JAX's (the whole
    work is 2.6-14.5 times that) and memory equals JAX's."""
    from jax.sharding import Mesh as JaxMesh

    from skycomputing_tpu.dataset import DataloaderGenerator as JaxLoaderGen
    from skycomputing_tpu.dynamics import ModelBenchmarker as JaxModelBench
    from skycomputing_tpu_torch.dataset import DataloaderGenerator
    from skycomputing_tpu_torch.dynamics import ModelBenchmarker
    from skycomputing_tpu_torch.parallel.mesh import make_1d_mesh

    kw = dict(vocab_size=512, hidden_size=128, num_hidden_layers=1,
              num_attention_heads=8, max_position_embeddings=256,
              dropout_prob=0.1, dtype="float32")
    data_cfg = dict(dataset_cfg=dict(type="RandomLmDataset", num_samples=8,
                                     seq_length=256, vocab_size=512),
                    dataloader_cfg=dict(batch_size=2, shuffle=True))
    flops, mem = ModelBenchmarker(tgpt.gpt_layer_configs(
        tgpt.GptConfig(**kw),
        mesh=make_1d_mesh(S, "sp", [torch.device("cpu")] * S)),
        DataloaderGenerator(data_cfg)).benchmark()
    ref_flops, ref_mem = JaxModelBench(jgpt.gpt_layer_configs(
        jgpt.GptConfig(**kw), mesh=JaxMesh(np.array(devices[:S]), ("sp",))),
        JaxLoaderGen(data_cfg)).benchmark()
    assert mem == ref_mem
    ratios = [got / ref for got, ref in zip(flops, ref_flops)]
    assert len(ratios) == 4 and all(0.90 <= r <= 1.10 for r in ratios), ratios
