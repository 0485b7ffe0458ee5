"""Interleaved (virtual-stage) schedules of the port's compiled BERT
pipeline: with V=2 chunks per position on a ('pp',) mesh of 4, the
wavefront (M=4 <= S) against the JAX engine (logits, and parameters
after two SGD steps, within 1e-5) and the loss falling; the grouped
Megatron schedule (M=8 > S) and a padded M (6, grouped as 8) against
the JAX engine of the same schedule on its weights (logits, loss and
gradient) and against the chunks applied one after another in model
order (logits and gradient), all within 1e-5; the schedules' cells in
JAX's tick order."""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
from skycomputing_tpu.parallel.spmd import (
    CompiledBertPipeline as JaxCompiledBertPipeline,
)
from skycomputing_tpu_torch import spmd_params_from_jax
from skycomputing_tpu_torch.parallel import (
    CompiledBertPipeline,
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
S, V = 4, 2


@pytest.fixture(scope="module")
def world(devices):
    jcfg, cfg = bert_cfgs()
    jpipe = JaxCompiledBertPipeline(jcfg, jax_pp_mesh(S, devices),
                                    units_per_stage=1, num_classes=3,
                                    num_microbatches=4, virtual_stages=V)
    batch, labels = bert_data()
    jparams = jpipe.init(jax.random.key(0), *batch)
    pipe = CompiledBertPipeline(cfg, make_pipeline_mesh(S, CPUS),
                                units_per_stage=1, num_microbatches=4,
                                virtual_stages=V)
    return jpipe, jparams, pipe, batch, labels


def _sequential_loss(pipe, params, batch, labels):
    """The 8 chunks in model order: chunk c at stacked position (c % S)
    * V + c // S, device c % S, slot c // S."""
    ids, types, mask = (torch.as_tensor(x) for x in batch)
    ends = {g: {n: l.shards[(0,)] for n, l in params[g].items()}
            for g in ("embeddings", "pooler", "classifier")}
    call = torch.func.functional_call
    hidden, mask4 = call(pipe.embeddings, ends["embeddings"],
                         (ids, types, mask))
    for c in range(S * V):
        chunk = {n: l.shards[(c % S,)][c // S]
                 for n, l in params["stages"].items()}
        hidden, mask4 = pipe.stage.apply(chunk, hidden, mask4)
    pooled = call(pipe.pooler, ends["pooler"], (hidden, mask4))
    logits = call(pipe.classifier, ends["classifier"], (pooled,))
    return logits, torch.nn.functional.cross_entropy(
        logits, torch.as_tensor(labels).long())


def test_interleaved_matches_sequential_chunks(world):
    jpipe, jparams, pipe, batch, labels = world
    params = port_params(pipe, jparams)
    with torch.no_grad():
        logits = pipe._logits(params, *batch).numpy()
        seq, _ = _sequential_loss(pipe, params, batch, labels)
    np.testing.assert_allclose(
        logits, np.asarray(jax.jit(jpipe._logits)(jparams, *batch)), rtol=0,
        atol=TOL)
    np.testing.assert_allclose(logits, seq.numpy(), rtol=0, atol=TOL)


def test_interleaved_trains(world):
    jpipe, jparams, pipe, batch, labels = world
    params = port_params(pipe, jparams)
    opt_state = pipe.init_opt_state(params)
    jp = jax_copy(jparams)
    jopt = jpipe.init_opt_state(jp)
    losses = []
    for i in range(5):
        params, opt_state, loss = pipe.train_step(params, opt_state, batch,
                                                  labels)
        losses.append(float(loss))
        if i < 2:
            jp, jopt, jloss = jpipe.train_step(jp, jopt, batch, labels)
            np.testing.assert_allclose(losses[-1], float(jloss), rtol=0,
                                       atol=TOL)
        if i == 1:
            assert_trees_close(pipe, params, jp)
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("M", [8, 6], ids=["grouped_M8", "padded_M6"])
def test_grouped_and_padded_match_sequential(devices, M):
    jcfg, cfg = bert_cfgs()
    jpipe = JaxCompiledBertPipeline(jcfg, jax_pp_mesh(S, devices),
                                    units_per_stage=1, num_microbatches=M,
                                    virtual_stages=V)
    pipe = CompiledBertPipeline(cfg, make_pipeline_mesh(S, CPUS),
                                units_per_stage=1, num_microbatches=M,
                                virtual_stages=V)
    batch, labels = bert_data(batch=2 * M, seed=M)
    jparams = jpipe.init(jax.random.key(M), *batch)
    params = port_params(pipe, jparams)
    loss, grads = pipe.value_and_grad(params, batch, labels)
    logits = pipe._logits(params, *batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jpipe.loss(q, batch, labels)))(jparams)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jax.jit(jpipe._logits)(jparams, *batch)), rtol=0,
        atol=TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=TOL)
    jgrads = spmd_params_from_jax(host(jgrads))
    for group, leaves in jgrads.items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(grads[group][name].numpy(),
                                       leaf.numpy(), rtol=0, atol=TOL,
                                       err_msg=name)
    ref_logits, ref_loss = _sequential_loss(pipe, params, batch, labels)
    np.testing.assert_allclose(logits.detach().numpy(),
                               ref_logits.detach().numpy(), rtol=0, atol=TOL)
    ref_loss.backward()
    # the pads' cotangents must not leak into real microbatches
    for name, leaf in params["stages"].items():
        full = torch.empty(leaf.shape)
        for pos, t in leaf.shards.items():
            full[leaf.slices(pos)] = t.grad
        np.testing.assert_allclose(grads["stages"][name].numpy(),
                                   full.numpy(), rtol=0, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(loss), float(ref_loss.detach()), rtol=0,
                               atol=TOL)


def test_schedules_follow_jax_ticks():
    """Every (chunk, microbatch) cell once, each chunk one tick after its
    predecessor; the grouped schedule's last tick M'V + S - 2."""
    _, cfg = bert_cfgs()
    for M in (2, 4, 6, 8):
        pipe = CompiledBertPipeline(cfg, make_pipeline_mesh(S, CPUS),
                                    units_per_stage=1, num_microbatches=M,
                                    virtual_stages=V)
        cells = pipe._cells(M)
        tick = {(k * S + d, m): t for t, d, k, m in cells}
        assert len(tick) == len(cells) == S * V * M
        for (c, m), t in tick.items():
            assert c == 0 or tick[(c - 1, m)] == t - 1
        if M > S:
            padded = -(-M // S) * S
            assert max(t for t, *_ in cells) <= padded * V + S - 2
        else:
            assert max(t for t, *_ in cells) == M + S * V - 2
