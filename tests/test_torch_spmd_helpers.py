"""Shared helpers of the compiled SPMD engines' port tests
(``tests/test_torch_spmd*.py``): the tiny configurations, the seeded
batches, moving the JAX engine's weights into a port engine
(``spmd_params_from_jax``), holding the two engines' parameter trees
against each other leaf by leaf (``spmd_params_to_jax``), and the
one-thread fixture every such module imports.  No tests here."""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models.gpt import GptConfig as JaxGptConfig
from skycomputing_tpu_torch import spmd_params_from_jax, spmd_params_to_jax
from skycomputing_tpu_torch.models import bert_config
from skycomputing_tpu_torch.models.gpt import GptConfig

CPUS = [torch.device("cpu")] * 8
# float32 logits and losses of the two engines on the same weights
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module of these tests runs: the
    engines issue many small ops per position, and under several test
    workers each op's thread pool otherwise waits on threads the other
    workers hold (the tests take ten times as long); restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def bert_cfgs(dropout=0.0, **kw):
    """(JAX, port) tiny BERT configs, float32."""
    args = dict(dtype="float32", hidden_dropout_prob=dropout,
                attention_probs_dropout_prob=dropout, **kw)
    return jax_bert_config("tiny", **args), bert_config("tiny", **args)


def gpt_cfgs(dropout=0.0):
    """(JAX, port) tiny GPT configs (``gpt_test_helpers``' model)."""
    args = dict(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                num_attention_heads=2, max_position_embeddings=64,
                dropout_prob=dropout, dtype="float32")
    return JaxGptConfig(**args), GptConfig(**args)


def bert_data(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, size=(batch, seq)).astype(np.int32)
    types = np.zeros_like(ids)
    mask = np.ones_like(ids)
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    return (ids, types, mask), labels


def gpt_data(batch=8, seq=16):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, size=(batch, seq)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_params(engine, jax_params, tp=1):
    """The JAX engine's weights placed on a port engine."""
    return engine.place(spmd_params_from_jax(host(jax_params), tp))


def assert_trees_close(engine, params, jax_params, tp=1, rtol=0.0,
                       atol=TOL):
    """Every leaf of a port engine's parameters (back in JAX's layout)
    against the JAX engine's."""
    ours = spmd_params_to_jax(engine.gather(params), tp)
    theirs = host(jax_params)
    paths = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert len(flat_ours) == len(paths)
    for path, leaf in paths:
        np.testing.assert_allclose(flat_ours[path], leaf, rtol=rtol,
                                   atol=atol, err_msg=str(path))


def jax_copy(tree):
    """A copy for a JAX train step, which donates its inputs."""
    return jax.tree_util.tree_map(lambda x: x + 0, tree)
