"""Reference-checkpoint conversion in the port
(``skycomputing_tpu_torch/utils/torch_convert.py`` and
``python -m skycomputing_tpu_torch.tools.convert_torch_checkpoint``)
against the JAX package's ``skycomputing_tpu/utils/torch_convert.py``:
the contracts of ``tests/test_torch_convert.py`` (round trip, the
semantics of ``Linear``, an unknown layer refused), the same reference
state dict through JAX's conversion and ``params_from_jax`` equal to the
port's bit for bit with tiny BERT's logits within 1e-5, and a randomly
initialised HuggingFace BERT converted as JAX converts it."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skycomputing_tpu.builder import build_layer_stack as jax_build_stack
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu.utils import torch_convert as jax_convert
from skycomputing_tpu_torch.builder import build_layer_stack
from skycomputing_tpu_torch.convert import params_from_jax
from skycomputing_tpu_torch.dynamics import ParameterServer
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.tools import convert_torch_checkpoint as tool
from skycomputing_tpu_torch.utils.torch_convert import (
    convert_hf_bert_state_dict,
    convert_layer,
    convert_state_dict,
    convert_torch_checkpoint,
    layer_to_torch,
    to_torch_state_dict,
)

pytestmark = pytest.mark.torch_port

F32 = dict(dtype="float32", hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


def reference_style_state_dict(cfg, n_units, n_classes, seed=0):
    """What the reference saves: ``ModuleList.state_dict()``, keys
    ``"{idx}.{path}"`` (as ``tests/test_torch_convert.py`` builds it,
    with LayerNorm weights drawn too)."""
    g = torch.Generator().manual_seed(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    state = {}

    def lin(prefix, din, dout):
        state[f"{prefix}.weight"] = torch.randn(dout, din, generator=g) * .02
        state[f"{prefix}.bias"] = torch.randn(dout, generator=g) * .02

    def ln(prefix, dim):
        state[f"{prefix}.weight"] = 1 + torch.randn(dim, generator=g) * .02
        state[f"{prefix}.bias"] = torch.randn(dim, generator=g) * .02

    state["0.word_embeddings.weight"] = torch.randn(V, H, generator=g) * .02
    state["0.position_embeddings.weight"] = torch.randn(
        cfg.max_position_embeddings, H, generator=g) * .02
    state["0.token_type_embeddings.weight"] = torch.randn(
        cfg.type_vocab_size, H, generator=g) * .02
    ln("0.LayerNorm", H)
    idx = 1
    for _ in range(n_units):
        for name in ("query", "key", "value"):
            lin(f"{idx}.attention.self.{name}", H, H)
        lin(f"{idx}.attention.output.dense", H, H)
        ln(f"{idx}.attention.output.LayerNorm", H)
        lin(f"{idx + 1}.intermediate.dense_act", H, I)
        lin(f"{idx + 2}.output.dense", I, H)
        ln(f"{idx + 2}.output.LayerNorm", H)
        idx += 3
    lin(f"{idx}.dense_act", H, H)
    lin(f"{idx + 1}.classifier", H, n_classes)
    return state


def _units(pkg_config, pkg_layers, n_units=2, **kw):
    return pkg_layers(pkg_config("tiny", **{**F32, **kw}),
                      num_encoder_units=n_units, num_classes=3,
                      deterministic=True)


def _batch(vocab=1024):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    return ids, np.zeros_like(ids), np.ones_like(ids)


def _port_logits(units, state_dicts, data):
    stack = build_layer_stack(units)
    for module, sd in zip(stack.layers, state_dicts):
        module.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return stack.eval()(*(torch.from_numpy(x) for x in data)).numpy()


def test_full_checkpoint_roundtrip(tmp_path):
    units = _units(bert_config, bert_layer_configs)
    state = reference_style_state_dict(bert_config("tiny"), 2, 3)
    ckpt = tmp_path / "epoch_1.pth"
    torch.save(state, ckpt)
    converted = convert_torch_checkpoint(str(ckpt), units)
    assert len(converted) == len(units)
    fresh = build_layer_stack(units)
    for sd, module in zip(converted, fresh.layers):
        want = module.state_dict()
        assert {k: v.shape for k, v in sd.items()} == {
            k: v.shape for k, v in want.items()}
    logits = _port_logits(units, converted, _batch())
    assert np.all(np.isfinite(logits))
    back = to_torch_state_dict(converted, units)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_linear_semantics():
    """The reference's ``y = x W^T + b`` with ``W [out, in]`` is the
    port's: the weight is taken as it is."""
    W, b = torch.randn(6, 4), torch.randn(6)
    converted = convert_layer("BertTailForClassification",
                              {"classifier.weight": W.numpy(),
                               "classifier.bias": b.numpy()})
    assert torch.equal(converted["classifier.weight"], W)
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32))
    assert torch.equal(F.linear(x, converted["classifier.weight"],
                                converted["classifier.bias"]),
                       F.linear(x, W, b))
    jax_kernel = jax_convert.convert_layer(
        "BertTailForClassification",
        {"classifier.weight": W.numpy(), "classifier.bias": b.numpy()},
    )["classifier"]["kernel"]
    assert np.array_equal(jax_kernel.T, converted["classifier.weight"])


def test_unknown_layer_type_and_key_rejected():
    with pytest.raises(ValueError, match="no conversion rule"):
        convert_layer("MysteryLayer", {})
    with pytest.raises(ValueError, match="no conversion rule"):
        layer_to_torch("MysteryLayer", {})
    with pytest.raises(KeyError, match="no rule maps"):
        convert_layer("BertPooler", {"mystery.weight": np.zeros(2)})
    units = _units(bert_config, bert_layer_configs)
    state = reference_style_state_dict(bert_config("tiny"), 1, 3)
    with pytest.raises(ValueError, match="layers"):
        convert_state_dict(state, units)


def test_conversion_equals_jax_through_params_from_jax(tmp_path):
    """One reference checkpoint through JAX's conversion and
    ``params_from_jax``, and through the port's: bit for bit, and tiny
    BERT's logits on it within 1e-5 of JAX's."""
    units = _units(bert_config, bert_layer_configs)
    jax_units = _units(jax_bert_config, jax_bert_layers)
    state = reference_style_state_dict(bert_config("tiny"), 2, 3, seed=3)
    ckpt = str(tmp_path / "ref.pth")
    torch.save(state, ckpt)
    jax_params = jax_convert.convert_torch_checkpoint(ckpt, jax_units)
    via_jax = params_from_jax(jax_params, units)
    ours = convert_torch_checkpoint(ckpt, units)
    for got, want in zip(ours, via_jax):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    data = _batch()
    want = np.asarray(jax_build_stack(jax_units).apply(jax_params, *data))
    np.testing.assert_allclose(_port_logits(units, ours, data), want,
                               rtol=0, atol=1e-5)
    # and back: the port's inverse equals JAX's on the same weights
    jax_back = jax_convert.to_torch_state_dict(jax_params, jax_units)
    ours_back = to_torch_state_dict(ours, units)
    assert set(ours_back) == set(jax_back)
    assert all(torch.equal(ours_back[k], jax_back[k]) for k in jax_back)


def test_hf_bert_equals_jax_and_transformers(monkeypatch):
    # the PyTorch model only: importing TensorFlow's side is most of the
    # import's time
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, num_labels=3)
    torch.manual_seed(0)
    hf = transformers.BertForSequenceClassification(hf_cfg).eval()
    dims = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=64)
    units = _units(bert_config, bert_layer_configs, **dims)
    jax_units = _units(jax_bert_config, jax_bert_layers, **dims)
    ours = convert_hf_bert_state_dict(hf.state_dict(), units)
    via_jax = params_from_jax(
        jax_convert.convert_hf_bert_state_dict(hf.state_dict(), jax_units),
        units)
    for got, want in zip(ours, via_jax):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    data = _batch(vocab=512)
    with torch.no_grad():
        theirs = hf(**{name: torch.from_numpy(x.astype(np.int64))
                       for name, x in zip(("input_ids", "token_type_ids",
                                           "attention_mask"), data)}
                    ).logits.numpy()
    np.testing.assert_allclose(_port_logits(units, ours, data), theirs,
                               rtol=2e-4, atol=2e-5)
    headless = {k: v for k, v in hf.state_dict().items()
                if not k.startswith("classifier.")}
    with pytest.raises(KeyError, match="classifier"):
        convert_hf_bert_state_dict(headless, units)


def test_tool_writes_a_checkpoint_the_parameter_server_loads(tmp_path):
    units = bert_layer_configs(bert_config("tiny"), num_encoder_units=2,
                               num_classes=3)
    state = reference_style_state_dict(bert_config("tiny"), 2, 3, seed=5)
    torch.save(state, tmp_path / "epoch_1.pth")
    out = tmp_path / "out" / "epoch_1.pt"
    assert tool.main(["--checkpoint", str(tmp_path / "epoch_1.pth"),
                      "--out", str(out), "--preset", "tiny",
                      "--layer-num", "2"]) == 0
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(1))
    ps.load_weights_from_file(str(out))
    for got, want in zip(ps.params, convert_state_dict(state, units)):
        assert all(torch.equal(got[k], want[k]) for k in want)
