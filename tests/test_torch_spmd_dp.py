"""The port's compiled BERT pipeline on a ('dp', 'pp') mesh of 2 x 4
CPU positions against the JAX engine on the same mesh: logits equal
JAX's and the port's own ``pp``-only engine's; the gradient, summed over
``dp``, equal to the whole batch's (the ``pp``-only engine's and JAX's);
parameters after two SGD steps equal JAX's; the loss falls over five
steps.  Tolerance 1e-5 throughout."""

import jax
import numpy as np
import pytest

from skycomputing_tpu.parallel import make_dp_pp_mesh as jax_dp_pp_mesh
from skycomputing_tpu.parallel.spmd import (
    CompiledBertPipeline as JaxCompiledBertPipeline,
)
from skycomputing_tpu_torch import spmd_params_to_jax
from skycomputing_tpu_torch.parallel import (
    CompiledBertPipeline,
    make_dp_pp_mesh,
    make_pipeline_mesh,
)
from test_torch_spmd_helpers import (
    one_torch_thread,  # noqa: F401 - an autouse fixture
    CPUS,
    TOL,
    assert_trees_close,
    bert_cfgs,
    bert_data,
    host,
    jax_copy,
    port_params,
)

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def world(devices):
    jcfg, cfg = bert_cfgs()
    jpipe = JaxCompiledBertPipeline(jcfg, jax_dp_pp_mesh(2, 4, devices),
                                    units_per_stage=1, num_microbatches=2)
    batch, labels = bert_data(seed=2)
    jparams = jpipe.init(jax.random.key(0), *batch)
    dp = CompiledBertPipeline(cfg, make_dp_pp_mesh(2, 4, CPUS),
                              units_per_stage=1, num_microbatches=2)
    pp = CompiledBertPipeline(cfg, make_pipeline_mesh(4, CPUS),
                              units_per_stage=1, num_microbatches=2)
    return jpipe, jparams, dp, pp, batch, labels


def test_dp_pp_logits_match_pp_only(world):
    jpipe, jparams, dp, pp, batch, _ = world
    out_dp = dp._logits(port_params(dp, jparams), *batch).detach().numpy()
    out_pp = pp._logits(port_params(pp, jparams), *batch).detach().numpy()
    np.testing.assert_allclose(out_dp, out_pp, rtol=0, atol=TOL)
    ref = np.asarray(jax.jit(jpipe._logits)(jparams, *batch))
    np.testing.assert_allclose(out_dp, ref, rtol=0, atol=TOL)


def test_dp_grads_match_pp_only(world):
    """The dp reduction gives the whole batch's gradient, not a
    replica's half-batch one."""
    jpipe, jparams, dp, pp, batch, labels = world
    _, g_dp = dp.value_and_grad(port_params(dp, jparams), batch, labels)
    _, g_pp = pp.value_and_grad(port_params(pp, jparams), batch, labels)
    g_jax = host(jax.jit(jax.grad(jpipe.loss))(jparams, batch, labels))
    ours_dp, ours_pp = spmd_params_to_jax(g_dp), spmd_params_to_jax(g_pp)
    flat = jax.tree_util.tree_flatten_with_path(g_jax)[0]
    dp_leaves = dict(jax.tree_util.tree_flatten_with_path(ours_dp)[0])
    pp_leaves = dict(jax.tree_util.tree_flatten_with_path(ours_pp)[0])
    for path, ref in flat:
        np.testing.assert_allclose(dp_leaves[path], pp_leaves[path],
                                   rtol=0, atol=TOL, err_msg=str(path))
        np.testing.assert_allclose(dp_leaves[path], ref, rtol=0, atol=TOL,
                                   err_msg=str(path))


def test_dp_pp_train_step(world):
    jpipe, jparams, dp, _, batch, labels = world
    params = port_params(dp, jparams)
    leaf = params["stages"]["unit_0.head.self.query.weight"]
    assert len(leaf.shards) == 8  # pp-sharded, dp-replicated
    assert leaf.key((0, 1)) == leaf.key((1, 1)) != leaf.key((0, 2))
    opt_state = dp.init_opt_state(params)
    jp = jax_copy(jparams)
    jopt = jpipe.init_opt_state(jp)
    losses = []
    for i in range(5):
        params, opt_state, loss = dp.train_step(params, opt_state, batch,
                                                labels)
        losses.append(float(loss))
        if i < 2:
            jp, jopt, jloss = jpipe.train_step(jp, jopt, batch, labels)
            np.testing.assert_allclose(losses[-1], float(jloss), rtol=0,
                                       atol=TOL)
        if i == 1:
            assert_trees_close(dp, params, jp)
    assert losses[-1] < losses[0], losses
