"""Paged serving port contracts: the port's ``ServingEngine`` on the CPU
against the JAX package's paged ``ServingEngine`` on the same weights.

Greedy float32 streams must be token-identical to the JAX engine under
both of its attention bodies (the Pallas kernel in interpret mode, and
the XLA gather reference), through mixed-length waves, a shared-prefix
pair (radix hit + copy-on-write) and page exhaustion.
"""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.serving import Request as JaxRequest
from skycomputing_tpu.serving import ServingEngine as JaxEngine
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.ops.paged_attention import paged_attention
from skycomputing_tpu_torch.serving import (
    QueueFullError,
    Request,
    ServingEngine,
)

pytestmark = pytest.mark.torch_port

BASE = dict(num_slots=3, max_len=48, buckets=(8, 16, 32), page_size=8,
            prefill_batch=2)


@pytest.fixture(scope="module")
def gpt():
    cfg = GptConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=64,
                    dropout_prob=0.0, dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(7),
                                        np.ones((1, 5), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs)


def _workload(seed):
    """(prompt, max_new_tokens) pairs: mixed lengths, then a pair that
    shares an 18-token system prompt (18 % 8 != 0 -> COW clone)."""
    rng = np.random.default_rng(seed)
    mixed = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
             for n, m in [(5, 7), (3, 4), (12, 6), (7, 1), (16, 5)]]
    system = rng.integers(1, 512, (18,)).astype(np.int32)
    shared = [(np.concatenate(
        [system, rng.integers(1, 512, (t,)).astype(np.int32)]), 5)
        for t in (3, 4)]
    return mixed, shared


def _serve(engine, make_request, batches):
    """Run each batch to completion in turn; outputs in request order."""
    outs = []
    for batch in batches:
        reqs = [make_request(prompt=p, max_new_tokens=m) for p, m in batch]
        done = engine.run(reqs)
        outs += [done[r.request_id].tolist() for r in reqs]
    return outs


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_port_engine_token_identical_to_jax_engine(gpt, attn_impl):
    layer_cfgs, params, sds = gpt
    mixed, shared = _workload(0)
    batches = [mixed, shared[:1], shared[1:]]
    port = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                         **BASE)
    ref = JaxEngine(layer_cfgs, params, kv_layout="paged",
                    attn_impl=attn_impl, **BASE)
    assert _serve(port, Request, batches) == _serve(ref, JaxRequest,
                                                    batches)
    snap = port.stats.snapshot()
    assert snap["finished"] == 7 and snap["prefix_hits"] >= 1
    assert snap["prefix_tokens_reused"] >= 18 and snap["cow_copies"] >= 1
    assert snap["prefix_hits"] == ref.stats.prefix_hits
    assert snap["cow_copies"] == ref.stats.cow_copies
    assert paged_attention.launches == 0  # CPU tensors: plain version
    port._pool.check_consistency()


def test_page_exhaustion_queues_and_stays_identical(gpt):
    """More requests than the page pool holds: admission queues on page
    exhaustion, the pool never over-allocates, and every stream still
    equals the JAX engine's."""
    layer_cfgs, params, sds = gpt
    kw = dict(BASE, num_pages=6, max_concurrency=8)
    rng = np.random.default_rng(11)
    batch = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
             for n, m in [(4, 6), (5, 3), (12, 8), (6, 2), (2, 5), (9, 4)]]
    port = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                         **kw)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in batch]
    for r in reqs:
        port.submit(r)
    pages_seen = []
    while port.has_work():
        port.step()
        pages_seen.append(port.stats.pages_in_use)
    assert max(pages_seen) <= 6
    assert port.stats.queue_stalls > 0
    assert port.stats.finished == len(reqs)
    ref = JaxEngine(layer_cfgs, params, kv_layout="paged", attn_impl="xla",
                    **kw)
    assert [r.output().tolist() for r in reqs] == _serve(
        ref, JaxRequest, [batch])
    port._pool.check_consistency()


def test_sampling_is_request_local_and_seeded(gpt):
    """A temperature request draws the same tokens whether it runs alone
    or beside other requests, and its seed changes them."""
    layer_cfgs, _, sds = gpt
    prompt = np.arange(1, 9, dtype=np.int32)

    def sample(seed, crowd):
        engine = ServingEngine(layer_cfgs, sds, device="cpu",
                               kv_layout="paged",
                               **BASE)
        req = Request(prompt=prompt, max_new_tokens=8, temperature=1.0,
                      seed=seed)
        others = [Request(prompt=prompt[:n] + 3, max_new_tokens=6)
                  for n in range(2, 2 + crowd)]
        engine.run(others + [req])
        return req.tokens

    alone = sample(1, 0)
    assert alone == sample(1, 3)
    assert alone != sample(2, 0)


def test_queue_bound_reject_and_shed(gpt):
    layer_cfgs, _, sds = gpt
    prompt = np.arange(1, 6, dtype=np.int32)
    engine = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                           max_queue=2,
                           **BASE)
    first = [engine.submit(Request(prompt=prompt, max_new_tokens=2))
             for _ in range(2)]
    with pytest.raises(QueueFullError):
        engine.submit(Request(prompt=prompt, max_new_tokens=2))
    assert engine.stats.queue_rejections == 1
    shed = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                         max_queue=2,
                         queue_policy="shed", **BASE)
    olds = [shed.submit(Request(prompt=prompt, max_new_tokens=2))
            for _ in range(2)]
    new = shed.submit(Request(prompt=prompt, max_new_tokens=2))
    assert olds[0].status == "rejected"
    assert any(r is new for r in shed.queued_requests)
    shed.run()
    assert shed.stats.finished == 2 and len(first) == 2
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(Request(prompt=prompt, max_new_tokens=60))


@pytest.mark.parametrize("kwargs, feature", [
    pytest.param(dict(kv_layout="slot"), "handoff export needs a paged",
                 id="kwargs0-slot KV layout"),
])
def test_unported_features_raise(gpt, kwargs, feature):
    """The handoff plane rides swap records, which only a paged engine
    keeps: on the slot layout export, import and swap-record corruption
    refuse with the reference's ``ValueError`` (the slot layout itself:
    ``test_torch_serving_slot.py``; the handoff plane on paged engines:
    ``test_torch_disagg.py``)."""
    layer_cfgs, _, sds = gpt
    engine = ServingEngine(layer_cfgs, sds, device="cpu",
                           **dict(BASE, **kwargs))
    assert engine.kv_layout == "slot"
    with pytest.raises(ValueError, match=feature):
        engine.export_handoff(0)
    with pytest.raises(ValueError, match="handoff import needs a paged"):
        engine.import_handoff(None, {})
    with pytest.raises(ValueError, match="paged engines only"):
        engine.corrupt_swap_record()


def test_unported_methods_raise(gpt):
    """The handoff plane's methods, once unported, now answer as the
    reference's do on an idle paged engine: nothing decodes, so nothing
    exports; no record is parked, so nothing can be corrupted (None
    without ``force``, ``KeyError`` for a named request)."""
    layer_cfgs, _, sds = gpt
    engine = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                           **BASE)
    with pytest.raises(KeyError, match="not decoding here"):
        engine.export_handoff(0)
    with pytest.raises(KeyError, match="holds no swap record"):
        engine.corrupt_swap_record(0)
    assert engine.corrupt_swap_record() is None
    assert engine.corrupt_swap_record(force=True) is None
    assert engine.device == torch.device("cpu")
    # the live-metrics time series and exporter are ported
    # (tests/test_torch_exporter.py serves them over HTTP)
    series = engine.enable_timeseries(window=4)
    assert engine.enable_timeseries() is series
    assert "serving.iterations" in series.sample()
