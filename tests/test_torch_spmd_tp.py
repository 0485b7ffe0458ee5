"""Tensor parallelism inside the port's compiled BERT pipeline
(('dp', 'pp', 'tp') meshes of CPU positions): the port's Megatron split
of full stage weights equals the JAX package's (converted leaf by leaf)
and merges back exactly; on the same full weights (the JAX engine's
``init``) the TP engine at ``dp`` 1 and 2 equals JAX's TP engine on the
same layout and the port's plain engine — logits and losses within 1e-5,
the merged gradient within 1e-5 of the plain one, and every parameter
after two SGD steps within 1e-5, the replicated leaves' copies equal —
and trains."""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.parallel import make_dp_pp_tp_mesh as jax_tp_mesh
from skycomputing_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
from skycomputing_tpu.parallel.spmd import (
    CompiledBertPipeline as JaxCompiledBertPipeline,
)
from skycomputing_tpu.parallel.spmd import (
    split_stage_params_for_tp as jax_split,
)
from skycomputing_tpu_torch import spmd_params_from_jax
from skycomputing_tpu_torch.parallel import (
    CompiledBertPipeline,
    make_dp_pp_mesh,
    make_dp_pp_tp_mesh,
    make_pipeline_mesh,
)
from skycomputing_tpu_torch.parallel.spmd import (
    merge_stage_params_from_tp,
    split_stage_params_for_tp,
)
from test_torch_spmd_helpers import (
    CPUS,
    TOL,
    assert_trees_close,
    bert_cfgs,
    bert_data,
    host,
    jax_copy,
    one_torch_thread,  # noqa: F401 - an autouse fixture
    port_params,
)

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def full_weights(devices):
    """The JAX engine's init at pp=2, two units a stage, in the port's
    layout."""
    jcfg, _ = bert_cfgs()
    jpipe = JaxCompiledBertPipeline(jcfg, jax_pp_mesh(2, devices),
                                    units_per_stage=2)
    batch, _ = bert_data()
    jparams = host(jpipe.init(jax.random.key(0), *batch))
    return jparams, spmd_params_from_jax(jparams)


def test_split_merge_roundtrip(full_weights):
    jparams, tree = full_weights
    split = split_stage_params_for_tp(tree["stages"], 2)
    theirs = spmd_params_from_jax({"stages": jax_split(jparams["stages"], 2)},
                                  tp=2)["stages"]
    assert set(split) == set(theirs)
    for name in split:
        torch.testing.assert_close(split[name], theirs[name], rtol=0,
                                   atol=0, msg=name)
    merged = merge_stage_params_from_tp(split)
    for name, leaf in tree["stages"].items():
        assert torch.equal(merged[name], leaf), name
    q = split["unit_0.head.self.query.weight"]
    assert q.shape[1] == 2 and q.shape[2] * 2 == tree["stages"][
        "unit_0.head.self.query.weight"].shape[1]
    ln = split["unit_0.tail.LayerNorm.weight"]
    assert torch.equal(ln[:, 0], ln[:, 1])


@pytest.mark.parametrize("dp", [1, 2])
def test_tp_pipeline_matches_plain(full_weights, devices, dp):
    _, tree = full_weights
    jcfg, cfg = bert_cfgs()
    pp, tp = 2, 2
    batch, labels = bert_data()
    plain_mesh = (make_dp_pp_mesh(dp, pp, CPUS) if dp > 1
                  else make_pipeline_mesh(pp, CPUS))
    plain = CompiledBertPipeline(cfg, plain_mesh, units_per_stage=2,
                                 num_microbatches=2)
    tpd = CompiledBertPipeline(cfg, make_dp_pp_tp_mesh(dp, pp, tp, CPUS),
                               units_per_stage=2, num_microbatches=2)
    # JAX's TP engine splits the same init (key 0) into its shards
    jtp = JaxCompiledBertPipeline(jcfg, jax_tp_mesh(dp, pp, tp, devices),
                                  units_per_stage=2, num_microbatches=2)
    jp = jtp.init(jax.random.key(0), *batch)
    params = plain.place(tree)
    params_tp = port_params(tpd, jp, tp)
    assert_trees_close(tpd, params_tp, jp, tp, atol=0.0)
    with torch.no_grad():
        logits_tp = tpd._logits(params_tp, *batch).numpy()
        np.testing.assert_allclose(logits_tp, np.asarray(jax.jit(
            jtp._logits)(jp, *batch)), rtol=0, atol=TOL)
        np.testing.assert_allclose(
            logits_tp, plain._logits(params, *batch).numpy(), rtol=0,
            atol=TOL)

    # the gradients, merged: the replicated leaves' copies summed over tp
    _, g_plain = plain.value_and_grad(params, batch, labels)
    _, g_tp = tpd.value_and_grad(params_tp, batch, labels)
    merged = merge_stage_params_from_tp(g_tp["stages"])
    for name, g in g_plain["stages"].items():
        np.testing.assert_allclose(merged[name].numpy(), g.numpy(), rtol=0,
                                   atol=TOL, err_msg=name)
    opt, opt_tp = plain.init_opt_state(params), tpd.init_opt_state(params_tp)
    jp, jopt = jax_copy(jp), jtp.init_opt_state(jp)
    for _ in range(2):
        params, opt, loss = plain.train_step(params, opt, batch, labels)
        params_tp, opt_tp, loss_tp = tpd.train_step(params_tp, opt_tp,
                                                    batch, labels)
        jp, jopt, jloss = jtp.train_step(jp, jopt, batch, labels)
        np.testing.assert_allclose(float(loss_tp), float(jloss), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(float(loss), float(loss_tp), rtol=0,
                                   atol=TOL)
    assert_trees_close(tpd, params_tp, jp, tp)
    ours, theirs = plain.gather(params), tpd.gather(params_tp)
    merged = merge_stage_params_from_tp(theirs["stages"])
    for name, leaf in ours["stages"].items():
        np.testing.assert_allclose(merged[name].numpy(), leaf.numpy(),
                                   rtol=0, atol=TOL, err_msg=name)
    for group in ("embeddings", "pooler", "classifier"):
        for name, leaf in ours[group].items():
            np.testing.assert_allclose(theirs[group][name].numpy(),
                                       leaf.numpy(), rtol=0, atol=TOL)
    # every copy of a replicated leaf took the same update
    ln = params_tp["stages"]["unit_0.tail.LayerNorm.weight"]
    for (d, p, t), local in ln.shards.items():
        assert torch.equal(local, ln.shards[(d, p, 0)]), (d, p, t)


def test_tp_pipeline_trains():
    _, cfg = bert_cfgs()
    pipe = CompiledBertPipeline(cfg, make_dp_pp_tp_mesh(2, 2, 2, CPUS),
                                units_per_stage=1, num_microbatches=2,
                                learning_rate=1e-2)
    batch, labels = bert_data()
    params = pipe.init(0)
    opt = pipe.init_opt_state(params)
    losses = []
    for _ in range(4):
        params, opt, loss = pipe.train_step(params, opt, batch, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
