"""GPT's mixture-of-experts block in the port against the JAX package
(``skycomputing_tpu/ops/moe.py``, ``models/gpt.py:GptBlock_MoeMlp``):
routing (``router_probs``, ``top_k_dispatch`` at top-1 and top-2, with
capacity to spare and capacity that binds) equal on the same
probabilities (dispatch and combine at atol 1e-7, the aux loss at
1e-6), ``moe_dispatch_combine``, the block on the same weights at rtol
2e-5 / atol 2e-6 with its aux loss, one expert equal to the dense MLP
(``tests/test_moe.py:49-70``), the interleaved layer configs, the
seeded init, an MoE stack through ``PipelineModel`` for two SGD steps
against JAX's at rtol 1e-4 / atol 1e-6, and the router's gradient.
The probabilities are seeded random floats, so no two experts tie."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models import gpt as jgpt
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.ops import moe as jmoe
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu_torch import build_layer_stack, params_from_jax
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.models import gpt as tgpt
from skycomputing_tpu_torch.ops import causal_lm_loss, moe as tmoe
from skycomputing_tpu_torch.parallel import PipelineModel, sgd

pytestmark = pytest.mark.torch_port

BLOCK_TOL = dict(rtol=2e-5, atol=2e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
CPU = [torch.device("cpu")]
LR = 1e-2
VOCAB, SEQ = 256, 16


def _cfg(pkg, dropout=0.0):
    return pkg.GptConfig(vocab_size=VOCAB, hidden_size=32,
                         num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=64,
                         dropout_prob=dropout, dtype="float32")


def _probs(seed, T=24, E=4):
    rng = np.random.default_rng(seed)
    return np.array(jax.nn.softmax(
        jnp.asarray(rng.standard_normal((T, E)).astype(np.float32)), -1))


# --- routing ------------------------------------------------------------------

@pytest.mark.parametrize("top_k, capacity", [(1, 8), (2, 12), (1, 3), (2, 5)],
                         ids=["top1", "top2", "top1_binding",
                              "top2_binding"])
def test_top_k_dispatch_equals_jax(top_k, capacity):
    probs = _probs(top_k * 10 + capacity)
    d_ref, c_ref, aux_ref = jmoe.top_k_dispatch(jnp.asarray(probs), capacity,
                                               top_k)
    d, c, aux = tmoe.top_k_dispatch(torch.from_numpy(probs), capacity, top_k)
    assert d.shape == c.shape == (24, 4, capacity)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=0, atol=1e-6)
    routed = d.sum(dim=(1, 2))
    if capacity * 4 < 24 * top_k:  # the buffers are full: tokens dropped
        assert float(routed.min()) < top_k
        assert float(d.sum()) == pytest.approx(
            float(np.asarray(d_ref).sum()))


def test_router_probs_and_dispatch_combine_equal_jax():
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((24, 32)).astype(np.float32)
    router = rng.standard_normal((32, 4)).astype(np.float32) * 0.1
    w = rng.standard_normal((4, 32, 32)).astype(np.float32) * 0.1
    p_ref = jmoe.router_probs(jnp.asarray(tokens), jnp.asarray(router))
    p = tmoe.router_probs(torch.from_numpy(tokens), torch.from_numpy(router))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), **BLOCK_TOL)
    d_ref, c_ref, _ = jmoe.top_k_dispatch(p_ref, 8, 2)
    d, c, _ = tmoe.top_k_dispatch(p, 8, 2)
    out_ref = jmoe.moe_dispatch_combine(
        jnp.asarray(tokens), d_ref, c_ref,
        lambda buf: jnp.einsum("ech,ehk->eck", buf, jnp.asarray(w)))
    out = tmoe.moe_dispatch_combine(
        torch.from_numpy(tokens), d, c,
        lambda buf: torch.einsum("ech,ehk->eck", buf, torch.from_numpy(w)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **BLOCK_TOL)


# --- the block ------------------------------------------------------------------

def _jax_block(top_k, capacity_factor, num_experts=4, x=None):
    block = jgpt.GptBlock_MoeMlp(_cfg(jgpt).to_dict(),
                                 num_experts=num_experts, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 deterministic=True, return_aux=True)
    params = block.init({"params": jax.random.key(top_k)}, x)["params"]
    out, aux = block.apply({"params": params}, x)
    return jax.device_get(params), np.asarray(out), float(aux)


def _port_block(params, top_k, capacity_factor, num_experts=4, **kw):
    cfg = dict(layer_type="GptBlock_MoeMlp", config=_cfg(tgpt).to_dict(),
               num_experts=num_experts, top_k=top_k,
               capacity_factor=capacity_factor, deterministic=True)
    block = tgpt.GptBlock_MoeMlp(cfg["config"], num_experts, top_k,
                                 capacity_factor, True, **kw)
    block.load_state_dict(params_from_jax([params], [cfg])[0], strict=True)
    return block


@pytest.mark.parametrize("top_k, capacity_factor",
                         [(1, 1.25), (2, 1.25), (2, 0.5)],
                         ids=["top1", "top2", "top2_binding"])
def test_block_equals_jax_with_its_aux_loss(top_k, capacity_factor):
    x = np.random.default_rng(11).standard_normal((2, 12, 32)).astype(
        np.float32)
    params, ref, aux_ref = _jax_block(top_k, capacity_factor, x=x)
    block = _port_block(params, top_k, capacity_factor)
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **BLOCK_TOL)
    np.testing.assert_allclose(float(block.aux_loss), aux_ref, rtol=0,
                               atol=1e-6)
    both = _port_block(params, top_k, capacity_factor, return_aux=True)
    with torch.no_grad():
        out2, aux2 = both(torch.from_numpy(x))
    np.testing.assert_allclose(out2.numpy(), ref, **BLOCK_TOL)
    assert float(aux2) == float(block.aux_loss)


def test_single_expert_equals_dense_mlp():
    """One expert with ample capacity takes every token at gate 1.0: the
    port's ``GptBlock_Mlp`` on the same weights."""
    x = np.random.default_rng(1).standard_normal((2, 8, 32)).astype(
        np.float32)
    params, _, _ = _jax_block(1, 1.0, num_experts=1, x=x)
    moe = _port_block(params, 1, 1.0, num_experts=1)
    dense = tgpt.GptBlock_Mlp(_cfg(tgpt).to_dict(), deterministic=True)
    sd = moe.state_dict()
    dense.load_state_dict({
        "ln_2.weight": sd["ln_2.weight"], "ln_2.bias": sd["ln_2.bias"],
        "c_fc.weight": sd["w1"][0].T, "c_fc.bias": sd["b1"][0],
        "c_proj.weight": sd["w2"][0].T, "c_proj.bias": sd["b2"][0]})
    with torch.no_grad():
        np.testing.assert_allclose(moe(torch.from_numpy(x)).numpy(),
                                   dense(torch.from_numpy(x)).numpy(),
                                   **BLOCK_TOL)


def test_router_gradient_is_nonzero():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 32)).astype(np.float32))
    params, _, _ = _jax_block(2, 1.25, x=x.numpy())
    block = _port_block(params, 2, 1.25)
    block(x).square().sum().backward()
    for name in ("router", "w1", "b1", "w2", "b2"):
        grad = getattr(block, name).grad
        assert grad is not None and float(grad.abs().max()) > 0, name


@pytest.mark.parametrize("moe_every, top_k", [(0, 1), (1, 2), (2, 1),
                                              (3, 2)])
def test_layer_configs_equal_jax(moe_every, top_k):
    port = tgpt.gpt_layer_configs(_cfg(tgpt), num_blocks=6,
                                  moe_every=moe_every, num_experts=4,
                                  moe_top_k=top_k, moe_capacity_factor=1.5)
    ref = jgpt.gpt_layer_configs(_cfg(jgpt), num_blocks=6,
                                 moe_every=moe_every, num_experts=4,
                                 moe_top_k=top_k, moe_capacity_factor=1.5)
    assert port == ref
    moe = [u for u in port if u["layer_type"] == "GptBlock_MoeMlp"]
    assert len(moe) == (6 // moe_every if moe_every else 0)


def test_seeded_and_numpy_inits_cover_the_block():
    units = tgpt.gpt_layer_configs(_cfg(tgpt), moe_every=1, num_experts=4)
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(0))
    drawn = tgpt.random_state_dicts(units, seed=0)
    stack = build_layer_stack(units)
    for module, sd, sd2 in zip(stack.layers, ps.params, drawn):
        module.load_state_dict(sd, strict=True)
        module.load_state_dict(sd2, strict=True)
    moe = ps.params[2]
    assert float(moe["b1"].abs().max()) == 0.0
    assert float(moe["w1"].std()) == pytest.approx(0.02, rel=0.1)


# --- two SGD steps through PipelineModel --------------------------------------

def _units(pkg):
    return pkg.gpt_layer_configs(_cfg(pkg), deterministic=True, moe_every=1,
                                 num_experts=4, moe_top_k=2)


def _ids():
    rng = np.random.default_rng(4)
    return rng.integers(0, VOCAB, (4, SEQ)).astype(np.int32)


def _pool(manager_cls, n):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n)])
    return wm


@pytest.fixture(scope="module")
def jax_steps(devices):
    units = _units(jgpt)
    ids = _ids()
    wm = _pool(JaxWorkerManager, 3)
    JaxAllocator(units, wm, None, None).even_allocate()
    ps = JaxParameterServer(units, example_inputs=(ids,),
                            rng=jax.random.key(0))
    init = params_from_jax(ps.params, units)
    model = JaxPipelineModel(wm, ps, optax.sgd(LR), jlosses.causal_lm_loss,
                             devices=devices, num_microbatches=2)
    losses = [model.train_step((ids,), ids, rng=jax.random.key(i))
              for i in range(2)]
    model.sync_to_parameter_server()
    return dict(units=units, ids=ids, init=init, losses=losses,
                trained=params_from_jax(ps.params, units))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_moe_stack_trains_as_jax(jax_steps, schedule):
    units = _units(tgpt)
    assert units == jax_steps["units"]
    wm = _pool(WorkerManager, 3)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=jax_steps["init"])
    model = PipelineModel(wm, ps, sgd(LR), causal_lm_loss, devices=CPU,
                          num_microbatches=2, schedule=schedule)
    ids = jax_steps["ids"]
    losses = [model.train_step((ids,), ids) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_steps["losses"], **TRAIN_TOL)
    model.sync_to_parameter_server()
    for got, ref in zip(ps.params, jax_steps["trained"]):
        assert sorted(got) == sorted(ref)
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       **TRAIN_TOL, err_msg=key)
