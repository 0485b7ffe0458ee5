"""Tensor parallelism for the monolithic model in the port
(``parallel/tensor_parallel.py``) against the JAX package's GSPMD path:
the per-leaf specs are ``_spec_for``'s in the port's ``[out, in]``
layout; over 8 CPU positions the sharded forward, its gradient and
SGD steps equal the JAX stack's replicated forward, gradient and optax
steps on the same weights (within 1e-5); the sharded leaves stay
sharded."""

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu.ops import cross_entropy_loss as jax_ce
from skycomputing_tpu.parallel.tensor_parallel import (
    make_tp_mesh as jax_make_tp_mesh,
)
from skycomputing_tpu.parallel.tensor_parallel import (
    tp_shardings as jax_tp_shardings,
)
from skycomputing_tpu_torch import build_layer_stack, params_from_jax
from skycomputing_tpu_torch.convert import state_dict_to_jax
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import (
    Sgd,
    make_tp_mesh,
    shard_params,
    tp_apply,
    tp_shardings,
    tp_train_step_fn,
)
from skycomputing_tpu_torch.parallel.sharded import leaves_of, \
    reduce_gradients
from test_torch_spmd_helpers import (
    CPUS,
    TOL,
    host,
    one_torch_thread,  # noqa: F401 - an autouse fixture
)

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def world(devices):
    kw = dict(dtype="float32", hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, num_attention_heads=8)
    jcfgs = jax_bert_layers(jax_bert_config("tiny", **kw),
                            num_encoder_units=2, num_classes=3,
                            deterministic=True)
    cfgs = bert_layer_configs(bert_config("tiny", **kw), num_encoder_units=2,
                              num_classes=3, deterministic=True)
    jstack = jax_build(jcfgs)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 1024, size=(8, 16)).astype(np.int32)
    batch = (ids, np.zeros_like(ids), np.ones_like(ids))
    labels = rng.integers(0, 3, size=(8,)).astype(np.int32)
    jparams = host(jstack.init(jax.random.key(0), *batch))
    stack = build_layer_stack(cfgs)
    sds = params_from_jax(jparams, cfgs)
    return jstack, jparams, stack, sds, batch, labels, devices


def test_kernels_get_expected_shardings(world):
    jstack, jparams, stack, sds, *_, devices = world
    specs = tp_shardings(sds, make_tp_mesh(8, CPUS))
    jspecs = jax_tp_shardings(jparams, jax_make_tp_mesh(8, devices))
    for layer, (ours, theirs) in enumerate(zip(specs, jspecs)):
        named = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(lambda s: s.spec, theirs))[0])
        assert len(named) == len(ours)
        for name, spec in ours.items():
            # the leaf's path in JAX's tree, and its spec in JAX's layout
            (path, _), = jax.tree_util.tree_flatten_with_path(
                state_dict_to_jax({name: torch.zeros(1)}))[0]
            if name.endswith(".weight") and len(spec) == 2:
                spec = spec[::-1]  # [out, in] -> the [in, out] kernel
            want = tuple(named[path])
            assert tuple(spec) == want + (None,) * (len(spec) - len(want)), (
                layer, name)
    head = specs[1]
    assert head["self.query.weight"] == ("tp", None)  # column-parallel
    assert head["output.dense.weight"] == (None, "tp")  # row-parallel
    assert head["output.LayerNorm.weight"] == ()


def test_tp_forward_matches_replicated(world):
    jstack, jparams, stack, sds, batch, *_ = world
    sharded = shard_params(sds, make_tp_mesh(8, CPUS))
    with torch.no_grad():
        out = tp_apply(stack, sharded, *batch).numpy()
    ref = np.asarray(jstack.apply(jparams, *batch))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_tp_grads_match_replicated(world):
    jstack, jparams, stack, sds, batch, labels, _ = world
    sharded = shard_params(sds, make_tp_mesh(8, CPUS))
    cross_entropy_loss(tp_apply(stack, sharded, *batch),
                       torch.as_tensor(labels)).backward()
    grads = reduce_gradients(leaves_of(sharded))
    g_ref = host(jax.grad(lambda p: jax_ce(jstack.apply(p, *batch),
                                           labels))(jparams))
    it = iter(grads)
    ours = []
    for layer in sharded:
        sd = {}
        for name, leaf in layer.items():
            g = next(it)
            full = torch.empty(leaf.shape)
            for pos, t in g.items():
                full[leaf.slices(pos)] = t
            sd[name] = full
        ours.append(state_dict_to_jax(sd))
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    mine = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    for path, ref in flat:
        np.testing.assert_allclose(mine[path], ref, rtol=0, atol=TOL,
                                   err_msg=str(path))


def test_tp_train_step_learns_and_stays_sharded(world):
    jstack, jparams, stack, sds, batch, labels, _ = world
    opt = Sgd(1e-2)
    sharded = shard_params(sds, make_tp_mesh(8, CPUS))
    opt_state = opt.init(sharded)
    step = tp_train_step_fn(stack, cross_entropy_loss, opt)
    jopt = optax.sgd(1e-2)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(
            lambda q: jax_ce(jstack.apply(q, *batch), labels))(p)
        u, o = jopt.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    jp, jo = jparams, jopt.init(jparams)
    losses = []
    for i in range(5):
        sharded, opt_state, loss = step(sharded, opt_state, batch, labels)
        losses.append(float(loss))
        if i < 2:
            jp, jo, jloss = jstep(jp, jo)
            np.testing.assert_allclose(losses[-1], float(jloss), rtol=0,
                                       atol=TOL)
    assert losses[-1] < losses[0], losses
    q = sharded[1]["self.query.weight"]
    assert q.spec == ("tp", None) and q.shards[(0,)].shape[0] * 8 == q.shape[0]
