"""BERT unit port contracts: each unit of ``models/bert.py`` and the whole
``tiny`` stack, in float32 with flash attention on and off, against the
Flax modules of the JAX package on the same weights (moved with
``params_from_jax``) and the same numpy inputs, at rtol 1e-4 / atol
1e-5; plus the layer-config lists, ``BertLayer_BodyShard`` against
``BertLayer_Body``, the nested param-tree conversion and the bf16 mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models import bert as jbert
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu_torch import LAYER, build_layer_stack, params_from_jax
from skycomputing_tpu_torch.models import bert as tbert
from skycomputing_tpu_torch.models import bert_config

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-5)
B, L = 2, 16


def _cfg(flash, **kw):
    return bert_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0,
                       use_flash_attention=flash, **kw)


def _batch(seed=0, pad=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, (B, L)).astype(np.int32)
    types = rng.integers(0, 2, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - pad:] = 0  # padded tail on the second row
    return ids, types, mask


def _pair(layer_cfg, example, seed=0):
    """(flax module, its params, the port module on the same weights)."""
    jstack = jax_build([layer_cfg])
    params = jax.device_get(jstack.init(jax.random.key(seed), *example))
    tstack = build_layer_stack([layer_cfg])
    (sd,) = params_from_jax(params, [layer_cfg])
    tstack.layers[0].load_state_dict(sd, strict=True)
    return jstack.modules[0], params[0], tstack.layers[0]


def _close(port, ref):
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), **TOL)


def _hidden(seed, width):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, L, width)).astype(np.float32)


def _ext_mask(mask):
    return ((1.0 - mask[:, None, None, :].astype(np.float32))
            * -10000.0).astype(np.float32)


@pytest.mark.parametrize("ffn_shards", [1, 2])
def test_layer_configs_and_registry_match_jax(ffn_shards):
    jcfg = jax_bert_config("tiny", use_flash_attention=True)
    ref = jbert.bert_layer_configs(jcfg, num_encoder_units=2,
                                   deterministic=True, ffn_shards=ffn_shards)
    port = tbert.bert_layer_configs(
        bert_config("tiny", use_flash_attention=True), num_encoder_units=2,
        deterministic=True, ffn_shards=ffn_shards)
    assert port == ref
    for layer_cfg in port:
        assert layer_cfg["layer_type"] in LAYER


def test_embeddings_match_flax():
    cfg = _cfg(False)
    layer_cfg = dict(layer_type="BertEmbeddings", config=cfg.to_dict(),
                     deterministic=True)
    batch = _batch()
    jmod, params, tmod = _pair(layer_cfg, batch)
    ref = jmod.apply({"params": params}, *batch)
    _close(tmod(*(torch.from_numpy(a) for a in batch)), ref)


def test_bfloat16_mask_is_jax_bfloat16_mask():
    """The mask is computed in the model dtype: -10000 rounds to -9984.
    (The JAX module gives that for device arrays, as its pipeline feeds
    it; a numpy mask would be promoted to float32 by numpy first.)"""
    cfg = bert_config("tiny", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    layer_cfg = dict(layer_type="BertEmbeddings", config=cfg.to_dict(),
                     deterministic=True)
    batch = _batch()
    jmod, params, tmod = _pair(layer_cfg, batch)
    _, ref = jmod.apply({"params": params}, *map(jnp.asarray, batch))
    assert ref.dtype == jnp.bfloat16
    _, mask = tmod(*(torch.from_numpy(a) for a in batch))
    assert mask.dtype == torch.bfloat16
    np.testing.assert_array_equal(mask.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert mask.float().min().item() == -9984.0


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_head_matches_flax(flash):
    cfg = _cfg(flash)
    layer_cfg = dict(layer_type="BertLayer_Head", config=cfg.to_dict(),
                     deterministic=True)
    example = (_hidden(1, 128), _ext_mask(_batch()[2]))
    jmod, params, tmod = _pair(layer_cfg, example)
    assert tmod.self.uses_flash(L) == flash
    ref = jmod.apply({"params": params}, *example)
    _close(tmod(*(torch.from_numpy(a) for a in example)), ref)


@pytest.mark.parametrize("unit", ["BertLayer_Body", "BertLayer_Tail",
                                  "BertPooler", "BertLayer_BodyShard/0",
                                  "BertLayer_BodyShard/1"])
def test_unit_matches_flax(unit):
    cfg = _cfg(False)
    mask = _ext_mask(_batch()[2])
    kind, _, shard = unit.partition("/")
    layer_cfg = dict(layer_type=kind, config=cfg.to_dict(),
                     deterministic=True)
    if kind == "BertLayer_Tail":
        example = (_hidden(2, 512), _hidden(3, 128), mask)
    elif kind == "BertLayer_BodyShard" and shard == "1":
        layer_cfg.update(shard=1, num_shards=2)
        example = (_hidden(2, 256), _hidden(3, 128), mask)
    else:
        if shard:
            layer_cfg.update(shard=0, num_shards=2)
        example = (_hidden(3, 128), mask)
    jmod, params, tmod = _pair(layer_cfg, example)
    ref = jmod.apply({"params": params}, *example)
    _close(tmod(*(torch.from_numpy(a) for a in example)), ref)


def test_classification_tail_matches_flax():
    layer_cfg = dict(layer_type="BertTailForClassification",
                     hidden_dropout_prob=0.0, hidden_size=128,
                     num_classes=3, deterministic=True, dtype="float32")
    pooled = np.random.default_rng(4).standard_normal((B, 128)).astype(
        np.float32)
    jmod, params, tmod = _pair(layer_cfg, (pooled,))
    ref = jmod.apply({"params": params}, pooled)
    out = tmod(torch.from_numpy(pooled))
    assert out.dtype == torch.float32 and out.shape == (B, 3)
    _close(out, ref)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_tiny_stack_matches_flax(flash):
    cfg = _cfg(flash)
    layer_cfgs = tbert.bert_layer_configs(cfg, num_encoder_units=2,
                                          deterministic=True)
    batch = _batch(5)
    jstack = jax_build(layer_cfgs)
    params = jax.device_get(jstack.init(jax.random.key(7), *batch))
    ref = jstack.apply(params, *batch)
    tstack = build_layer_stack(layer_cfgs)
    for module, sd in zip(tstack.layers, params_from_jax(params, layer_cfgs)):
        module.load_state_dict(sd, strict=True)
    out = tstack(*(torch.from_numpy(a) for a in batch))
    assert out.shape == (B, 3)
    _close(out, ref)


def test_body_shards_equal_body():
    """Two ``BertLayer_BodyShard`` units on ``split_body_params`` of a
    body's weights reproduce ``BertLayer_Body``."""
    cfg = _cfg(False)
    body = LAYER.get_module("BertLayer_Body")(cfg.to_dict(), True)
    shards = [LAYER.get_module("BertLayer_BodyShard")(cfg.to_dict(), k, 2,
                                                      True)
              for k in range(2)]
    for shard, sd in zip(shards, tbert.split_body_params(body.state_dict(),
                                                         2)):
        shard.load_state_dict(sd, strict=True)
    x = torch.from_numpy(_hidden(6, 128))
    mask = torch.from_numpy(_ext_mask(_batch()[2]))
    ref = body(x, mask)
    out = shards[1](*shards[0](x, mask))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_nested_param_trees_convert_to_dotted_keys():
    cfg = _cfg(True)
    layer_cfg = dict(layer_type="BertLayer_Head", config=cfg.to_dict(),
                     deterministic=True)
    example = (_hidden(1, 128), _ext_mask(_batch()[2]))
    params = jax.device_get(jax_build([layer_cfg]).init(
        jax.random.key(0), *example))
    (sd,) = params_from_jax(params, [layer_cfg])
    assert sorted(sd) == sorted(
        tbert.BertLayer_Head(cfg.to_dict(), True).state_dict())
    np.testing.assert_array_equal(
        sd["self.query.weight"].numpy(),
        np.asarray(params[0]["self"]["query"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["output.LayerNorm.weight"].numpy(),
        np.asarray(params[0]["output"]["LayerNorm"]["scale"]))
    bad = {"self": params[0]["self"]}
    with pytest.raises(ValueError, match="expected"):
        params_from_jax([bad], [layer_cfg])


def test_bfloat16_stack_tracks_flax_bfloat16():
    """The main path's precision (bf16 compute, flash on): the port's
    logits stay within bf16 rounding of the JAX package's."""
    cfg = bert_config("tiny", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    layer_cfgs = tbert.bert_layer_configs(cfg, num_encoder_units=2,
                                          deterministic=True)
    batch = _batch(8)
    jstack = jax_build(layer_cfgs)
    params = jax.device_get(jstack.init(jax.random.key(3), *batch))
    ref = np.asarray(jstack.apply(params, *map(jnp.asarray, batch)))
    tstack = build_layer_stack(layer_cfgs)
    for module, sd in zip(tstack.layers, params_from_jax(params, layer_cfgs)):
        module.load_state_dict(sd, strict=True)
    out = tstack(*(torch.from_numpy(a) for a in batch))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0.05,
                               atol=0.05)
