"""``skycomputing_tpu_torch/utils/profiling.py`` against the JAX package's
``skycomputing_tpu/utils/profiling.py`` on the same BERT ``tiny``
inputs: ``compiled_cost``'s FLOPs within 1% of XLA's for each float32
unit's forward and for the whole train step (forward, backward, SGD
update), its byte keys from the shapes, and the profiler helpers on the
CPU."""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build_stack
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu.ops import cross_entropy_loss as jax_cross_entropy
from skycomputing_tpu.utils.profiling import compiled_cost as jax_cost
from skycomputing_tpu_torch.builder import build_layer_stack
from skycomputing_tpu_torch.convert import params_from_jax
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.tools.bench_mfu import train_step
from skycomputing_tpu_torch.utils.profiling import (
    annotate,
    compiled_cost,
    kernel_names,
    trace,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

B, L = 4, 16
TOL = 0.01  # port FLOPs within 1% of XLA's
DROPOUT_OFF = dict(dtype="float32", hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 1024, (B, L)).astype(np.int32)
    labels = rng.integers(0, 3, (B,)).astype(np.int32)
    return (ids, np.zeros_like(ids), np.ones_like(ids)), labels


@pytest.fixture(scope="module")
def models():
    """(JAX stack, its params, the port's stack on the same weights,
    the layer configs, the batch)."""
    data, labels = _batch()
    jax_units = jax_bert_layers(jax_bert_config("tiny", **DROPOUT_OFF),
                                num_encoder_units=2, num_classes=3,
                                deterministic=True)
    stack = jax_build_stack(jax_units)
    params = jax.device_get(stack.init(jax.random.key(0), *data))
    units = bert_layer_configs(bert_config("tiny", **DROPOUT_OFF),
                               num_encoder_units=2, num_classes=3,
                               deterministic=True)
    port = build_layer_stack(units)
    for module, sd in zip(port.layers, params_from_jax(params, units)):
        module.load_state_dict(sd, strict=True)
    return stack, params, port, units, data, labels


def test_unit_flops_within_one_percent_of_xla(models):
    stack, params, port, units, data, _ = models
    acts = tuple(torch.from_numpy(np.asarray(x)) for x in data)
    jax_acts = data
    for module, p, unit, cfg in zip(stack.modules, params, port.layers,
                                    units):
        want = jax_cost(lambda p, *d: module.apply({"params": p}, *d), p,
                        *jax_acts)["flops"]
        got = compiled_cost(unit, *acts)["flops"]
        assert abs(got / want - 1) <= TOL, (cfg["layer_type"], got, want)
        jax_out = module.apply({"params": p}, *jax_acts)
        jax_acts = jax_out if isinstance(jax_out, tuple) else (jax_out,)
        with torch.no_grad():
            out = unit(*acts)
        acts = out if isinstance(out, tuple) else (out,)


def test_train_step_flops_within_one_percent_of_xla(models):
    stack, params, port, units, data, labels = models
    opt = optax.sgd(1e-3)

    def step(p, s):
        loss, grads = jax.value_and_grad(lambda p: jax_cross_entropy(
            stack.apply(p, *data), labels))(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    want = jax_cost(step, params, opt.init(params))["flops"]
    ids, types, mask = (torch.from_numpy(x) for x in data)
    before = [p.detach().clone() for p in port.parameters()]
    got = compiled_cost(train_step, port, ids, types, mask,
                        torch.from_numpy(labels))["flops"]
    assert abs(got / want - 1) <= TOL, (got, want)
    # the count ran on meta copies: the weights did not move
    assert all(torch.equal(a, b) for a, b in zip(before, port.parameters()))


def test_byte_keys_from_the_shapes(models):
    _, _, port, _, data, _ = models
    unit = port.layers[2]  # BertLayer_Body
    hidden = torch.zeros(B, L, 128)
    mask4 = torch.zeros(B, 1, 1, L)
    cost = compiled_cost(unit, hidden, mask4)
    params = sum(p.numel() * 4 for p in unit.parameters())
    assert cost["argument_bytes"] == params + hidden.numel() * 4 + mask4.numel() * 4
    # (intermediate [B, L, 512], hidden, mask)
    assert cost["output_bytes"] == 4 * (B * L * 512 + hidden.numel()
                                        + mask4.numel())
    assert cost["bytes_accessed"] == (cost["argument_bytes"]
                                      + cost["output_bytes"])
    # off the card there is no memory measurement, as in JAX without
    # XLA's memory analysis
    assert "temp_bytes" not in cost and "optimal_seconds" not in cost


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path), cuda=False) as prof:
        with annotate("tiny_matmul"):
            (x @ x).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(ev.get("name") == "tiny_matmul" for ev in events)
    assert any(e.key == "tiny_matmul" for e in prof.key_averages())
    assert kernel_names(prof) == []  # no card: no device kernel
