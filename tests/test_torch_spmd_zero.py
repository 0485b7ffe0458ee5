"""ZeRO-1/2/3 in the port's compiled BERT pipeline on a ('dp', 'pp')
mesh of 2 x 4 CPU positions, Adam at optax's defaults (lr 1e-3), against
the JAX engine: every position holds tensors of the shapes of the JAX
arrays' shards on the same mesh position (ZeRO-1's optimizer state,
ZeRO-3's parameters and state); ZeRO-1, ZeRO-2 and ZeRO-3 (GPipe,
interleaved and with tp) train as JAX's engine of the same layout does
from its own init, ZeRO-2 also as the port's ZeRO-1 and ZeRO-3 as the
port's replicated engine, to the JAX ZeRO tests' tolerances (losses rtol
2e-5, parameters rtol 2e-4, atol 2e-5); the guards raise as JAX's do."""

import jax
import numpy as np
import optax
import pytest

from skycomputing_tpu.parallel import make_dp_pp_mesh as jax_dp_pp_mesh
from skycomputing_tpu.parallel import make_dp_pp_tp_mesh as jax_tp_mesh
from skycomputing_tpu.parallel.spmd import (
    CompiledBertPipeline as JaxCompiledBertPipeline,
)
from skycomputing_tpu_torch import spmd_params_to_jax
from skycomputing_tpu_torch.parallel import (
    Adam,
    CompiledBertPipeline,
    make_dp_pp_mesh,
    make_dp_pp_tp_mesh,
    make_pipeline_mesh,
)
from skycomputing_tpu_torch.parallel.sharded import leaves_of
from test_torch_spmd_helpers import (
    one_torch_thread,  # noqa: F401 - an autouse fixture
    CPUS,
    assert_trees_close,
    bert_cfgs,
    bert_data,
    jax_copy,
    port_params,
)

pytestmark = pytest.mark.torch_port
LOSS_RTOL, RTOL, ATOL = 2e-5, 2e-4, 2e-5  # tests/test_spmd_zero1.py's


@pytest.fixture(scope="module")
def jax_worlds(devices):
    jcfg, _ = bert_cfgs()
    mesh = jax_dp_pp_mesh(2, 4, devices)
    batch, labels = bert_data()
    out = {}
    for name, kw in (("zero1", dict(zero1=True)),
                     ("zero2", dict(zero1=True, zero2=True)),
                     ("zero3", dict(zero3=True))):
        out[name] = _jax_world(jcfg, mesh, batch, **kw)
    return out, batch, labels


def _jax_world(jcfg, mesh, batch, units=1, **kw):
    """A JAX engine with Adam(1e-3), its init (key 0) and its state."""
    pipe = JaxCompiledBertPipeline(jcfg, mesh, units_per_stage=units,
                                   num_microbatches=2,
                                   optimizer=optax.adam(1e-3), **kw)
    params = pipe.init(jax.random.key(0), *batch)
    return pipe, params, pipe.init_opt_state(params)


def _engine(mesh=None, **kw):
    _, cfg = bert_cfgs()
    return CompiledBertPipeline(cfg, mesh or make_dp_pp_mesh(2, 4, CPUS),
                                units_per_stage=kw.pop("units", 1),
                                num_microbatches=2, optimizer=Adam(1e-3),
                                **kw)


def _local_shapes(tree, pos, tp=1):
    """The port tree's local tensors at ``pos``, in JAX's layout."""
    local = {g: {n: leaf.shards[pos] for n, leaf in leaves.items()}
             for g, leaves in tree.items()}
    return jax.tree_util.tree_map(np.shape, spmd_params_to_jax(local, tp))


def _assert_shard_shapes(port_tree, jax_tree, jax_mesh):
    for pos in np.ndindex(jax_mesh.devices.shape):
        dev = jax_mesh.devices[pos]
        want = jax.tree_util.tree_map(
            lambda a: {s.device: s.data.shape
                       for s in a.addressable_shards}[dev], jax_tree)
        assert _local_shapes(port_tree, pos) == want, pos


def test_zero1_shards_state_over_dp(jax_worlds):
    worlds, *_ = jax_worlds
    jpipe, jparams, jopt = worlds["zero1"]
    pipe = _engine(zero1=True)
    params = port_params(pipe, jparams)
    opt_state = pipe.init_opt_state(params)
    _assert_shard_shapes(opt_state["mu"], jopt[0].mu, jpipe.mesh)
    _assert_shard_shapes(params, jparams, jpipe.mesh)
    sharded = [leaf for leaf in leaves_of(opt_state["mu"]["stages"])
               if "dp" in leaf.spec]
    assert sharded
    for leaf in sharded:  # pp=4 x dp=2: 1/8 of the stacked tensor
        assert leaf.nbytes((0, 0)) * 8 <= np.prod(leaf.shape) * 4


def _train_as_jax(pipe, world, batch, labels, tp=1, steps=2):
    """Two steps of the port engine ``pipe`` and the JAX engine of
    ``world`` from the JAX engine's init: the losses and every parameter
    after the steps agree."""
    jpipe, jparams, jopt = world
    params = port_params(pipe, jparams, tp)
    opt_state = pipe.init_opt_state(params)
    jp, jo = jax_copy(jparams), jax_copy(jopt)
    for _ in range(steps):
        params, opt_state, loss = pipe.train_step(params, opt_state, batch,
                                                  labels)
        jp, jo, jloss = jpipe.train_step(jp, jo, batch, labels)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
    assert_trees_close(pipe, params, jp, tp, rtol=RTOL, atol=ATOL)
    return params


def test_zero1_training_matches_jax(jax_worlds):
    worlds, batch, labels = jax_worlds
    _train_as_jax(_engine(zero1=True), worlds["zero1"], batch, labels)


def _train_pair(a, b, batch, labels, steps=3, seed=0):
    pa, pb = a.init(seed), b.init(seed)
    oa, ob = a.init_opt_state(pa), b.init_opt_state(pb)
    for _ in range(steps):
        pa, oa, la = a.train_step(pa, oa, batch, labels)
        pb, ob, lb = b.train_step(pb, ob, batch, labels)
        np.testing.assert_allclose(float(la), float(lb), rtol=LOSS_RTOL)
    ta, tb = a.gather(pa), b.gather(pb)
    for group in ta:
        for name in ta[group]:
            np.testing.assert_allclose(ta[group][name].numpy(),
                                       tb[group][name].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    return pb, ob


def test_zero2_matches_zero1_training(jax_worlds):
    worlds, batch, labels = jax_worlds
    _train_as_jax(_engine(zero1=True, zero2=True), worlds["zero2"], batch,
                  labels)
    _, opt2 = _train_pair(_engine(zero1=True),
                          _engine(zero1=True, zero2=True), batch, labels)
    assert opt2["count"] == 3


def test_zero3_shards_params_over_dp(jax_worlds):
    worlds, *_ = jax_worlds
    jpipe, jparams, jopt = worlds["zero3"]
    pipe = _engine(zero3=True)
    params = port_params(pipe, jparams)
    _assert_shard_shapes(params, jparams, jpipe.mesh)
    _assert_shard_shapes(pipe.init_opt_state(params)["mu"], jopt[0].mu,
                         jpipe.mesh)
    dp_leaves = [leaf for leaf in leaves_of(params["stages"])
                 if "dp" in leaf.spec]
    assert dp_leaves
    for leaf in dp_leaves:
        assert leaf.nbytes((1, 3)) * 8 <= np.prod(leaf.shape) * 4


@pytest.mark.parametrize("layout", ["gpipe", "interleaved", "tp"])
def test_zero3_matches_replicated_training(jax_worlds, devices, layout):
    """Sharding the stage parameters is bookkeeping: the gather's
    backward returns each shard its gradient.  The port's ZeRO-3 engine
    trains as JAX's of the same layout and as the port's replicated
    one."""
    worlds, batch, labels = jax_worlds
    jcfg, _ = bert_cfgs()
    kw, mesh, tp, world = {}, None, 1, worlds["zero3"]
    if layout == "interleaved":
        mesh, kw = make_dp_pp_mesh(2, 2, CPUS), dict(virtual_stages=2)
        world = _jax_world(jcfg, jax_dp_pp_mesh(2, 2, devices), batch,
                           zero3=True, **kw)
    elif layout == "tp":
        mesh, kw, tp = make_dp_pp_tp_mesh(2, 2, 2, CPUS), dict(units=2), 2
        world = _jax_world(jcfg, jax_tp_mesh(2, 2, 2, devices), batch,
                           zero3=True, **kw)
    pz = _train_as_jax(_engine(mesh, zero3=True, **kw), world, batch,
                       labels, tp)
    assert any("dp" in leaf.spec for leaf in leaves_of(pz["stages"]))
    _train_pair(_engine(mesh, **kw), _engine(mesh, zero3=True, **kw),
                batch, labels)


def test_zero_guards():
    _, cfg = bert_cfgs()
    pp = make_pipeline_mesh(4, CPUS)
    for kw in ("zero1", "zero3"):
        with pytest.raises(ValueError, match="dp"):
            CompiledBertPipeline(cfg, pp, units_per_stage=1, **{kw: True})
    with pytest.raises(ValueError, match="zero2 extends zero1"):
        CompiledBertPipeline(cfg, make_dp_pp_mesh(2, 4, CPUS),
                             units_per_stage=1, zero2=True)
    for kw in ("zero1", "zero3"):
        with pytest.raises(RuntimeError, match="init"):
            _engine(**{kw: True}).make_train_step()
