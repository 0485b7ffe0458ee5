"""Expert parallelism in the port (``parallel/expert_parallel.py``)
against the JAX package (``tests/test_moe.py::
test_expert_parallel_sharding_matches_replicated``): a GPT stack with
every second MLP an 8-expert MoE, its JAX weights sharded over 4 CPU
positions (2 experts each); the expert-parallel forward, the positions'
partial outputs summed in the combine, equals the JAX stack's
replicated forward within 1e-5; an expert count that does not divide
is refused."""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models.gpt import GptConfig as JaxGptConfig
from skycomputing_tpu.models.gpt import gpt_layer_configs as jax_gpt_layers
from skycomputing_tpu_torch import build_layer_stack, params_from_jax
from skycomputing_tpu_torch.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu_torch.parallel import (
    ep_apply,
    make_ep_mesh,
    shard_moe_params,
)
from test_torch_spmd_helpers import (
    CPUS,
    TOL,
    host,
    one_torch_thread,  # noqa: F401 - an autouse fixture
)

pytestmark = pytest.mark.torch_port


def test_expert_parallel_sharding_matches_replicated():
    kw = dict(vocab_size=256, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=64, dropout_prob=0.0, dtype="float32")
    jcfgs = jax_gpt_layers(JaxGptConfig(**kw), deterministic=True,
                           moe_every=2, num_experts=8)
    cfgs = gpt_layer_configs(GptConfig(**kw), deterministic=True,
                             moe_every=2, num_experts=8)
    jstack = jax_build(jcfgs)
    ids = np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)
    jparams = jstack.init(jax.random.key(0), ids)
    ref = np.asarray(jstack.apply(jparams, ids))

    sds = params_from_jax(host(jparams), cfgs)
    sharded = shard_moe_params(sds, make_ep_mesh(4, CPUS))
    w1 = sharded[4]["w1"]  # block 2's MoE (embeddings, attn, mlp, attn, moe)
    assert w1.spec[0] == "ep" and len(w1.shards) == 4
    assert all(t.shape[0] == 2 for t in w1.shards.values())
    with torch.no_grad():
        out = ep_apply(build_layer_stack(cfgs), sharded, ids).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)

    with pytest.raises(ValueError, match="not divisible"):
        shard_moe_params(sds, make_ep_mesh(3, CPUS))
