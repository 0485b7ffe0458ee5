"""The compiled SPMD BERT pipeline of the port
(``skycomputing_tpu_torch/parallel/spmd.py``) against the JAX package's
on a ('pp',) mesh of 4: the JAX engine's own weights go through
``spmd_params_from_jax`` into the port engine on 4 CPU positions.  Stage
leaves stacked and sharded over ``pp`` with the JAX shards' shapes; the
pipelined logits equal JAX's and the port's own stage-by-stage
application (within 1e-5); parameters after two SGD steps equal JAX's
(within 1e-5) and the loss falls over six; with
``use_flash_attention=True`` in both engines (B1's plain version on the
CPU, the JAX kernel's reference there) the forward and one step agree
within 1e-5."""

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from skycomputing_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
from skycomputing_tpu.parallel.spmd import (
    CompiledBertPipeline as JaxCompiledBertPipeline,
)
from skycomputing_tpu_torch import spmd_params_from_jax, spmd_params_to_jax
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


def _world(devices, flash):
    jcfg, cfg = bert_cfgs(use_flash_attention=flash)
    jpipe = JaxCompiledBertPipeline(jcfg, jax_pp_mesh(4, devices),
                                    units_per_stage=1, num_classes=3,
                                    num_microbatches=4)
    batch, labels = bert_data()
    jparams = jpipe.init(jax.random.key(0), *batch)
    pipe = CompiledBertPipeline(cfg, make_pipeline_mesh(4, CPUS),
                                units_per_stage=1, num_classes=3,
                                num_microbatches=4)
    return jpipe, jparams, pipe, batch, labels


@pytest.fixture(scope="module")
def world(devices):
    return _world(devices, flash=False)


def test_stage_params_sharded_over_pp(world):
    jpipe, jparams, pipe, batch, _ = world
    params = port_params(pipe, jparams)
    jleaf = jparams["stages"]["unit_0"]["head"]["self"]["query"]["kernel"]
    leaf = params["stages"]["unit_0.head.self.query.weight"]
    assert leaf.shape[0] == 4 and leaf.spec[0] == "pp"
    by_device = {s.device: s.data.shape for s in jleaf.addressable_shards}
    for p, dev in enumerate(jpipe.mesh.devices.flatten()):
        local = leaf.shards[(p,)]
        # one stacked stage per position, the JAX shard's transpose
        assert tuple(local.shape) == (1, *by_device[dev][1:][::-1])
    embed = params["embeddings"]["word_embeddings.weight"]
    assert all(tuple(t.shape) == embed.shape for t in embed.shards.values())
    jembed = jparams["embeddings"]["word_embeddings"]["embedding"]
    assert jembed.sharding.is_fully_replicated


def test_converter_round_trip(world):
    """JAX's tree -> the port's -> JAX's again, bitwise; Dense kernels
    arrive transposed."""
    _, jparams, *_ = world
    tree = spmd_params_from_jax(host(jparams))
    q = tree["stages"]["unit_0.head.self.query.weight"]
    jq = host(jparams)["stages"]["unit_0"]["head"]["self"]["query"]["kernel"]
    assert torch.equal(q, torch.from_numpy(np.array(jq)).transpose(1, 2))
    back = spmd_params_to_jax(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           host(jparams))


def _sequential(pipe, params, batch):
    """The stages applied one after another on the port's modules."""
    home = (0,)
    ids, types, mask = (torch.as_tensor(x) for x in batch)
    ends = {g: {n: l.shards[home] for n, l in params[g].items()}
            for g in ("embeddings", "pooler", "classifier")}
    hidden, mask4 = functional_call(pipe.embeddings, ends["embeddings"],
                                    (ids, types, mask))
    for s in range(4):
        stage = {n: l.shards[(s,)][0]
                 for n, l in params["stages"].items()}
        hidden, mask4 = pipe.stage.apply(stage, hidden, mask4)
    pooled = functional_call(pipe.pooler, ends["pooler"], (hidden, mask4))
    return functional_call(pipe.classifier, ends["classifier"], (pooled,))


def test_pipelined_matches_sequential(world):
    jpipe, jparams, pipe, batch, _ = world
    params = port_params(pipe, jparams)
    with torch.no_grad():
        logits = pipe._logits(params, *batch)
        seq = _sequential(pipe, params, batch)
    ref = np.asarray(jax.jit(jpipe._logits)(jparams, *batch))
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), seq.numpy(), rtol=0,
                               atol=TOL)


def test_full_train_step_learns_and_matches_jax(world):
    jpipe, jparams, pipe, batch, labels = world
    params = port_params(pipe, jparams)
    opt_state = pipe.init_opt_state(params)
    step = pipe.make_train_step()
    jp = jax_copy(jparams)
    jopt = jpipe.init_opt_state(jp)
    jstep = jpipe.make_train_step()
    losses = []
    for i in range(6):
        params, opt_state, loss = step(params, opt_state, batch, labels)
        losses.append(float(loss))
        if i < 2:
            jp, jopt, jloss = jstep(jp, jopt, batch, labels)
            np.testing.assert_allclose(losses[-1], float(jloss), rtol=0,
                                       atol=TOL)
        if i == 1:  # two SGD steps: every parameter within 1e-5
            assert_trees_close(pipe, params, jp)
    assert losses[-1] < losses[0], losses
    assert len(params["stages"]["unit_0.tail.dense.weight"].shards) == 4


def test_flash_attention_path_matches_jax(devices):
    """``use_flash_attention=True`` in both engines: the port's stages
    call B1's wrapper (its plain version on the CPU)."""
    jpipe, jparams, pipe, batch, labels = _world(devices, flash=True)
    params = port_params(pipe, jparams)
    assert pipe.stage.unit_0.head.self.uses_flash(batch[0].shape[1])
    with torch.no_grad():
        logits = pipe._logits(params, *batch)
    ref = np.asarray(jax.jit(jpipe._logits)(jparams, *batch))
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=TOL)
    opt_state = pipe.init_opt_state(params)
    params, opt_state, loss = pipe.train_step(params, opt_state, batch,
                                              labels)
    jp = jax_copy(jparams)
    jp, _, jloss = jpipe.train_step(jp, jpipe.init_opt_state(jp), batch,
                                    labels)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=TOL)
    assert_trees_close(pipe, params, jp)
