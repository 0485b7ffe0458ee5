"""The port's compiled GPT pipeline (``parallel/spmd_gpt.py``) against
the JAX package's on the JAX engine's own weights: dense blocks on a
('pp',) mesh of 4 (logits within 1e-5) and on a ('dp', 'pp') mesh of
2 x 2, V=1 and 2 (the loss and every parameter after two SGD steps
within 1e-5, and the loss falling over four); MoE blocks, whose aux
loss rides the ring with its microbatch, under GPipe and both
interleaved schedules (logits and aux within 1e-5), trained with
ZeRO-1 Adam and through a padded grouped schedule (the losses and the
parameters after two steps against JAX's); ZeRO-3 equal to JAX's
ZeRO-3 (the gradient, and two SGD steps) and to the replicated engine;
a MoE pattern that does not divide the stage refused."""

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.parallel import CompiledGptPipeline as JaxGpt
from skycomputing_tpu.parallel import make_dp_pp_mesh as jax_dp_pp_mesh
from skycomputing_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
from skycomputing_tpu_torch import spmd_params_from_jax
from skycomputing_tpu_torch.parallel import (
    Adam,
    CompiledGptPipeline,
    make_dp_pp_mesh,
    make_pipeline_mesh,
)
from test_torch_spmd_helpers import (
    one_torch_thread,  # noqa: F401 - an autouse fixture
    CPUS,
    TOL,
    assert_trees_close,
    gpt_cfgs,
    gpt_data,
    host,
    jax_copy,
    port_params,
)

pytestmark = pytest.mark.torch_port


def _pair(devices, S, dp=1, **kw):
    jcfg, cfg = gpt_cfgs()
    jmesh = (jax_dp_pp_mesh(dp, S, devices) if dp > 1
             else jax_pp_mesh(S, devices))
    mesh = make_dp_pp_mesh(dp, S, CPUS) if dp > 1 else make_pipeline_mesh(
        S, CPUS)
    ids, _ = gpt_data(batch=kw.pop("batch", 8))
    jopt, opt = kw.pop("optimizer", (None, None))
    jpipe = JaxGpt(jcfg, jmesh, optimizer=jopt, **kw)
    jparams = jpipe.init(jax.random.key(0), ids)
    pipe = CompiledGptPipeline(cfg, mesh, optimizer=opt, **kw)
    return jpipe, jparams, pipe, port_params(pipe, jparams)


def _train_as_jax(jpipe, jparams, pipe, params, ids, labels, steps=4,
                  rtol=0.0, atol=TOL, loss_rtol=0.0, loss_atol=TOL):
    """``steps`` steps of the port engine from the JAX engine's weights,
    the first two against the JAX engine's (the losses, then every
    parameter); the losses, finite, fall."""
    opt = pipe.init_opt_state(params)
    jp = jax_copy(jparams)
    jopt = jpipe.init_opt_state(jp)
    losses = []
    for i in range(steps):
        params, opt, loss = pipe.train_step(params, opt, (ids,), labels)
        losses.append(float(loss))
        if i < 2:
            jp, jopt, jloss = jpipe.train_step(jp, jopt, (ids,), labels)
            np.testing.assert_allclose(losses[-1], float(jloss),
                                       rtol=loss_rtol, atol=loss_atol)
        if i == 1:
            assert_trees_close(pipe, params, jp, rtol=rtol, atol=atol)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    return params, opt


def test_gpt_pipeline_matches_jax(devices):
    jpipe, jparams, pipe, params = _pair(devices, 4, units_per_stage=1,
                                         num_microbatches=4)
    ids, _ = gpt_data()
    with torch.no_grad():
        logits = pipe._logits(params, ids).numpy()
    assert logits.shape == (8, 16, 512)
    ref = np.asarray(jax.jit(jpipe._logits)(jparams, ids))
    np.testing.assert_allclose(logits, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("virtual_stages", [1, 2])
def test_gpt_pipeline_trains(devices, virtual_stages):
    jpipe, jparams, pipe, params = _pair(
        devices, 2, dp=2, units_per_stage=2 // virtual_stages,
        num_microbatches=2, learning_rate=1e-2,
        virtual_stages=virtual_stages)
    _train_as_jax(jpipe, jparams, pipe, params, *gpt_data())


@pytest.mark.parametrize("S,V,M", [(4, 1, 4), (2, 2, 4), (2, 2, 2)],
                         ids=["gpipe", "grouped", "wavefront"])
def test_moe_pipeline_matches_jax(devices, S, V, M):
    jpipe, jparams, pipe, params = _pair(
        devices, S, units_per_stage=1, num_microbatches=M,
        virtual_stages=V, moe_every=1, num_experts=4)
    ids, _ = gpt_data()
    assert pipe.side_outputs
    with torch.no_grad():
        logits, aux = pipe._logits(params, ids)
    jlogits, jaux = jax.jit(jpipe._logits)(jparams, ids)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=TOL)


@pytest.mark.parametrize("layout", ["zero1_dp2", "padded_grouped"])
def test_moe_pipeline_trains(devices, layout):
    """MoE with ZeRO-1 Adam on dp x pp (the JAX ZeRO tests' tolerances:
    losses rtol 2e-5, parameters rtol 2e-4, atol 2e-5); MoE through the
    grouped interleaved schedule with a padded M (3 over S=2), SGD
    (within 1e-5); both against JAX's engine of the same layout."""
    moe = dict(moe_every=2, num_experts=4)
    if layout == "zero1_dp2":
        jpipe, jparams, pipe, params = _pair(
            devices, 2, dp=2, units_per_stage=2, num_microbatches=2,
            zero1=True, optimizer=(optax.adam(1e-3), Adam(1e-3)), **moe)
        ids, labels = gpt_data()
        tols = dict(rtol=2e-4, atol=2e-5, loss_rtol=2e-5, loss_atol=0.0)
    else:
        jpipe, jparams, pipe, params = _pair(
            devices, 2, units_per_stage=2, num_microbatches=3,
            virtual_stages=2, learning_rate=1e-2, batch=6, **moe)
        ids, labels = gpt_data(batch=6)
        tols = {}
    _, opt = _train_as_jax(jpipe, jparams, pipe, params, ids, labels,
                           **tols)
    if layout == "zero1_dp2":
        assert any("dp" in leaf.spec
                   for leaf in opt["mu"]["stages"].values())


def test_gpt_zero3_matches_replicated(devices):
    """ZeRO-3 is exact for the GPT engine too.  Against JAX's ZeRO-3
    engine on its weights: the reduced gradient within 1e-5, then two
    SGD steps at 1e-2 (the losses and every parameter within 1e-5).
    Against the port's replicated engine: three Adam steps at the JAX
    ZeRO tests' tolerances (losses rtol 2e-5, parameters rtol 2e-4, atol
    2e-5).  Adam is not held against JAX here: on this model a few
    gradients lie near its eps (1e-8), where it turns the two engines'
    float32 rounding of the gradient (about 1e-8 apart) into parameter
    differences of up to 4e-5 after two steps, replicated or not."""
    _, cfg = gpt_cfgs()
    ids, labels = gpt_data()
    jpipe, jparams, pipe, params = _pair(
        devices, 2, dp=2, units_per_stage=2, num_microbatches=2,
        zero3=True, learning_rate=1e-2)
    assert any("dp" in leaf.spec for leaf in params["stages"].values())
    _, grads = pipe.value_and_grad(params, (ids,), labels)
    jgrads = spmd_params_from_jax(host(jax.jit(jax.grad(
        lambda q: jpipe.loss(q, (ids,), labels)))(jparams)))
    for group, leaves in jgrads.items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(grads[group][name].numpy(),
                                       leaf.numpy(), rtol=0, atol=TOL,
                                       err_msg=name)
    _train_as_jax(jpipe, jparams, pipe, params, ids, labels, steps=2)
    pipes = [CompiledGptPipeline(cfg, make_dp_pp_mesh(2, 2, CPUS),
                                 units_per_stage=2, num_microbatches=2,
                                 optimizer=Adam(1e-3), zero3=zero3)
             for zero3 in (False, True)]
    params = [p.init(0) for p in pipes]
    opts = [p.init_opt_state(q) for p, q in zip(pipes, params)]
    for _ in range(3):
        out = [p.train_step(q, o, (ids,), labels)
               for p, q, o in zip(pipes, params, opts)]
        params, opts = [o[0] for o in out], [o[1] for o in out]
        np.testing.assert_allclose(float(out[0][2]), float(out[1][2]),
                                   rtol=2e-5)
    trees = [p.gather(q) for p, q in zip(pipes, params)]
    for group in trees[0]:
        for name, leaf in trees[0][group].items():
            np.testing.assert_allclose(trees[1][group][name].numpy(),
                                       leaf.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=name)
    assert any("dp" in leaf.spec for leaf in params[1]["stages"].values())


def test_moe_rejects_nondivisible_pattern():
    _, cfg = gpt_cfgs()
    pipe = CompiledGptPipeline(cfg, make_pipeline_mesh(2, CPUS),
                               units_per_stage=2, moe_every=3)
    with pytest.raises(ValueError, match="must divide"):
        pipe.init(0)
