"""Tensor parallelism inside the port's compiled GPT pipeline, dense and
MoE (expert tensors in the Megatron role tables: w1/b1 column, w2 row,
router and b2 replicated): the port's split equals the JAX package's
(converted leaf by leaf) and merges back exactly; on the same full
weights (the JAX engine's init) the (dp x) pp x tp engine equals JAX's
TP engine on the same layout and the port's plain engine — logits, aux
loss and losses within 1e-5, the merged gradient within 1e-5 of the
plain one, and every parameter after two SGD steps within 1e-5 — and
trains."""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.parallel import CompiledGptPipeline as JaxGpt
from skycomputing_tpu.parallel import make_dp_pp_tp_mesh as jax_tp_mesh
from skycomputing_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
from skycomputing_tpu.parallel.spmd import (
    split_stage_params_for_tp as jax_split,
)
from skycomputing_tpu.parallel import spmd_gpt as jax_spmd_gpt
from skycomputing_tpu_torch import spmd_params_from_jax
from skycomputing_tpu_torch.parallel import (
    CompiledGptPipeline,
    make_dp_pp_mesh,
    make_dp_pp_tp_mesh,
    make_pipeline_mesh,
)
from skycomputing_tpu_torch.parallel.spmd import (
    merge_stage_params_from_tp,
    split_stage_params_for_tp,
)
from skycomputing_tpu_torch.parallel.spmd_gpt import (
    GPT_MOE_TP_COL,
    GPT_MOE_TP_ROW,
    GPT_TP_COL,
    GPT_TP_ROW,
    TpGptMoeStage,
)
from test_torch_spmd_helpers import (
    CPUS,
    TOL,
    assert_trees_close,
    gpt_cfgs,
    gpt_data,
    host,
    jax_copy,
    one_torch_thread,  # noqa: F401 - an autouse fixture
    port_params,
)

pytestmark = pytest.mark.torch_port
MOE = dict(moe_every=2, num_experts=4)


@pytest.fixture(scope="module", params=["dense", "moe"])
def full_weights(request, devices):
    kw = MOE if request.param == "moe" else {}
    jcfg, _ = gpt_cfgs()
    jpipe = JaxGpt(jcfg, jax_pp_mesh(2, devices), units_per_stage=2, **kw)
    ids, _ = gpt_data()
    jparams = host(jpipe.init(jax.random.key(0), ids))
    roles = ((GPT_MOE_TP_COL, GPT_MOE_TP_ROW) if kw
             else (GPT_TP_COL, GPT_TP_ROW))
    return kw, jparams, spmd_params_from_jax(jparams), roles


def test_split_merge_roundtrip(full_weights):
    kw, jparams, tree, roles = full_weights
    split = split_stage_params_for_tp(tree["stages"], 2, *roles)
    jroles = ((jax_spmd_gpt.GPT_MOE_TP_COL, jax_spmd_gpt.GPT_MOE_TP_ROW)
              if kw else (jax_spmd_gpt.GPT_TP_COL, jax_spmd_gpt.GPT_TP_ROW))
    theirs = spmd_params_from_jax(
        {"stages": jax_split(jparams["stages"], 2, *jroles)}, tp=2)["stages"]
    for name in split:
        torch.testing.assert_close(split[name], theirs[name], rtol=0,
                                   atol=0, msg=name)
    merged = merge_stage_params_from_tp(split, *roles)
    for name, leaf in tree["stages"].items():
        assert torch.equal(merged[name], leaf), name
    if kw:
        w1 = split["unit_1.mlp.w1"]
        assert w1.shape[-1] * 2 == tree["stages"]["unit_1.mlp.w1"].shape[-1]
        router = split["unit_1.mlp.router"]
        assert torch.equal(router[:, 0], router[:, 1])


@pytest.mark.parametrize("dp", [1, 2])
def test_gpt_tp_pipeline_matches_plain(full_weights, devices, dp):
    kw, _, tree, roles = full_weights
    jcfg, cfg = gpt_cfgs()
    ids, labels = gpt_data()
    plain_mesh = (make_dp_pp_mesh(dp, 2, CPUS) if dp > 1
                  else make_pipeline_mesh(2, CPUS))
    plain = CompiledGptPipeline(cfg, plain_mesh, units_per_stage=2,
                                num_microbatches=2, **kw)
    tpd = CompiledGptPipeline(cfg, make_dp_pp_tp_mesh(dp, 2, 2, CPUS),
                              units_per_stage=2, num_microbatches=2, **kw)
    if kw:
        assert isinstance(tpd.tp_stage, TpGptMoeStage)
    # JAX's TP engine splits the same init (key 0) into its shards
    jtp = JaxGpt(jcfg, jax_tp_mesh(dp, 2, 2, devices), units_per_stage=2,
                 num_microbatches=2, **kw)
    jp = jtp.init(jax.random.key(0), ids)
    params = plain.place(tree)
    params_tp = port_params(tpd, jp, 2)
    assert_trees_close(tpd, params_tp, jp, 2, atol=0.0)
    with torch.no_grad():
        out, out_tp = plain._logits(params, ids), tpd._logits(params_tp, ids)
    jout = jax.jit(jtp._logits)(jp, ids)
    if kw:
        for aux in (float(out[1]), float(jout[1])):
            np.testing.assert_allclose(float(out_tp[1]), aux, rtol=0,
                                       atol=TOL)
        out, out_tp, jout = out[0], out_tp[0], jout[0]
    np.testing.assert_allclose(out_tp.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), out_tp.numpy(), rtol=0,
                               atol=TOL)
    _, g = plain.value_and_grad(params, (ids,), labels)
    _, g_tp = tpd.value_and_grad(params_tp, (ids,), labels)
    merged = merge_stage_params_from_tp(g_tp["stages"], *roles)
    for name, leaf in g["stages"].items():
        np.testing.assert_allclose(merged[name].numpy(), leaf.numpy(),
                                   rtol=0, atol=TOL, err_msg=name)
    opt, opt_tp = plain.init_opt_state(params), tpd.init_opt_state(params_tp)
    jp, jopt = jax_copy(jp), jtp.init_opt_state(jp)
    for _ in range(2):
        params, opt, loss = plain.train_step(params, opt, (ids,), labels)
        params_tp, opt_tp, loss_tp = tpd.train_step(params_tp, opt_tp,
                                                    (ids,), labels)
        jp, jopt, jloss = jtp.train_step(jp, jopt, (ids,), labels)
        np.testing.assert_allclose(float(loss_tp), float(jloss), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(float(loss), float(loss_tp), rtol=0,
                                   atol=TOL)
    assert_trees_close(tpd, params_tp, jp, 2)
    merged = merge_stage_params_from_tp(tpd.gather(params_tp)["stages"],
                                        *roles)
    for name, leaf in plain.gather(params)["stages"].items():
        np.testing.assert_allclose(merged[name].numpy(), leaf.numpy(),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_gpt_tp_pipeline_trains(moe):
    _, cfg = gpt_cfgs()
    pipe = CompiledGptPipeline(cfg, make_dp_pp_tp_mesh(1, 2, 2, CPUS),
                               units_per_stage=2, num_microbatches=2,
                               learning_rate=1e-2, **(MOE if moe else {}))
    ids, labels = gpt_data()
    params = pipe.init(0)
    opt = pipe.init_opt_state(params)
    losses = []
    for _ in range(4):
        params, opt, loss = pipe.train_step(params, opt, (ids,), labels)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
