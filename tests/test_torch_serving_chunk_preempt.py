"""Paged serving port contracts for chunked prefill and preemption: the
port's ``ServingEngine`` on the CPU against the JAX package's paged
``ServingEngine`` on the same weights.

Greedy float32 streams must be token-identical to the JAX engine under
both of its attention bodies, with equal feature counters:
``prefill_chunk`` (budgeted chunk waves beside decode), and swap and
recompute preemption of the same request at the same tick — whose
streams must also equal the un-preempted run's, with a swap record
whose checksum verifies.
"""

import jax
import numpy as np
import pytest

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.serving import Request as JaxRequest
from skycomputing_tpu.serving import ServingEngine as JaxEngine
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.serving import Request, ServingEngine
from skycomputing_tpu_torch.serving.engine import (
    _swap_record_checksum,
    _swap_record_nbytes,
)
from torch_test_helpers import one_thread  # noqa: F401

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


def _prompts(seed):
    """(prompt, max_new_tokens): long prompts (several chunks of 8) and
    short ones, two sharing a 13-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 512, (13,)).astype(np.int32)
    out = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
           for n, m in [(21, 6), (4, 9), (30, 5), (9, 8)]]
    out += [(np.concatenate([prefix, rng.integers(1, 512, (t,))
                             .astype(np.int32)]), 6) for t in (2, 7)]
    return out


def _drive(engine, make_request, prompts, preempt=None):
    """Submit everything, step to the end; ``preempt`` = (tick, request
    position, mode) preempts that request before that tick's step.
    Returns the streams in request order."""
    reqs = [make_request(prompt=p, max_new_tokens=m) for p, m in prompts]
    for r in reqs:
        engine.submit(r)
    tick = 0
    while engine.has_work():
        if preempt is not None and tick == preempt[0]:
            engine.preempt(reqs[preempt[1]].request_id, mode=preempt[2])
        engine.step()
        tick += 1
    return [r.output().tolist() for r in reqs]


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_chunked_prefill_token_identical_to_jax(gpt, attn_impl):
    """(d) prefill_chunk=8: prompts of up to 30 tokens prefill in chunk
    waves beside decode ticks; streams and chunk counters equal JAX's,
    and equal the one-shot prefill engine's streams."""
    layer_cfgs, params, sds = gpt
    prompts = _prompts(1)
    kw = dict(BASE, prefill_chunk=8)
    port = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                         **kw)
    ref = JaxEngine(layer_cfgs, params, kv_layout="paged",
                    attn_impl=attn_impl, **kw)
    streams = _drive(port, Request, prompts)
    assert streams == _drive(ref, JaxRequest, prompts)
    keys = ("prefill_chunks", "chunk_stalls", "prefill_waves",
            "prefill_tokens", "prefix_hits", "cow_copies")
    snap, jsnap = port.stats.snapshot(), ref.stats.snapshot()
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["prefill_chunks"] > len(prompts)  # long prompts chunked
    assert snap["chunk_stalls"] > 0
    port._pool.check_consistency()
    plain = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                          **BASE)
    assert _drive(plain, Request, prompts) == streams


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("mode, kv_dtype", [
    ("swap", None), ("recompute", None), ("swap", "int8")])
def test_preemption_token_identical_to_jax(gpt, attn_impl, mode, kv_dtype):
    """(e) preempting the same running request at the same tick in both
    engines: identical streams (equal to the un-preempted run's) and
    equal preemption counters; a swap record's checksum verifies over
    the host copies of its values (and scales)."""
    layer_cfgs, params, sds = gpt
    prompts = _prompts(2)
    kw = dict(BASE, kv_dtype=kv_dtype)
    unpreempted = _drive(
        ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                      **kw), Request, prompts)
    plan = (4, 0, mode)  # request 0 is decoding by tick 4
    port = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                         **kw)
    records = []
    preempt = port.preempt

    def preempt_and_keep(request_id, mode=None):
        out = preempt(request_id, mode=mode)
        records.append(port._swapped.get(request_id))
        return out

    port.preempt = preempt_and_keep
    streams = _drive(port, Request, prompts, preempt=plan)
    ref = JaxEngine(layer_cfgs, params, kv_layout="paged",
                    attn_impl=attn_impl, **kw)
    assert streams == _drive(ref, JaxRequest, prompts, preempt=plan)
    assert streams == unpreempted
    keys = ("preemptions", "swap_outs", "swap_ins", "swap_corruptions",
            "quantized_pages", "prefill_waves")
    snap, jsnap = port.stats.snapshot(), ref.stats.snapshot()
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["preemptions"] == 1
    assert snap["swap_ins"] == snap["swap_outs"] == (mode == "swap")
    record, = records
    if mode == "swap":
        assert record["checksum"] == _swap_record_checksum(
            record["pages"], record["index"], record["data"])
        assert record["nbytes"] == _swap_record_nbytes(record["data"]) > 0
    else:
        assert record is None
    port._pool.check_consistency()


def test_corrupt_swap_record_falls_back_to_recompute(gpt):
    """A swap record whose host bytes changed while parked fails its
    checksum at swap-in: it is dropped, counted, and the request resumes
    by recomputation with its stream intact."""
    layer_cfgs, _, sds = gpt
    prompts = _prompts(3)
    clean = _drive(ServingEngine(layer_cfgs, sds, device="cpu",
                                 kv_layout="paged",
                                 **BASE),
                   Request, prompts)
    engine = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                           preempt_policy="swap", **BASE)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in prompts]
    for r in reqs:
        engine.submit(r)
    for _ in range(4):
        engine.step()
    victim = reqs[0]
    engine.preempt(victim.request_id)  # preempt_policy="swap"
    k_host, _ = engine._swapped[victim.request_id]["data"][0][0]
    k_host.view(-1)[0] += 1.0  # host-pool rot
    engine.run()
    assert engine.stats.swap_corruptions == 1
    assert engine.stats.swap_ins == 0 and engine.stats.swap_outs == 1
    assert [r.output().tolist() for r in reqs] == clean
    engine._pool.check_consistency()


def test_drain_and_resume_elsewhere(gpt):
    """``drain`` evicts everything by recomputation, streams intact; the
    drained requests finish on a fresh engine as if never moved.  A
    chunked engine's mid-prefill requests drain too."""
    layer_cfgs, _, sds = gpt
    prompts = _prompts(4)
    clean = _drive(ServingEngine(layer_cfgs, sds, device="cpu",
                                 kv_layout="paged",
                                 **BASE),
                   Request, prompts)
    engine = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                           prefill_chunk=8,
                           **BASE)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in prompts]
    for r in reqs:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    assert engine.running_requests
    assert any(r.prefilled_len > 0 for r in engine.running_requests)
    drained = engine.drain()
    assert {r.request_id for r in drained} | {
        r.request_id for r in engine._finished
    } == {r.request_id for r in reqs}
    assert not engine.has_work() and engine.stats.preemptions > 0
    other = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                          **BASE)
    other.run(drained)
    assert [r.output().tolist() for r in reqs] == clean


def test_preempt_and_chunk_validation(gpt):
    layer_cfgs, _, sds = gpt
    with pytest.raises(ValueError, match="preempt_policy"):
        ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                      preempt_policy="x",
                      **BASE)
    with pytest.raises(ValueError, match="prefill buckets"):
        ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                      prefill_chunk=12,
                      **BASE)
    with pytest.raises(ValueError, match="max_chunk_rows"):
        ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                      max_chunk_rows=2,
                      **BASE)
    engine = ServingEngine(layer_cfgs, sds, device="cpu", kv_layout="paged",
                           prefill_chunk=8,
                           **BASE)
    req = engine.submit(Request(prompt=np.arange(1, 25, dtype=np.int32),
                                max_new_tokens=3))
    engine.step()  # enrolled: the first chunk of three ran
    assert req.prefilled_len == 8
    with pytest.raises(KeyError):
        engine.preempt(req.request_id + 1000)
    with pytest.raises(ValueError, match="mode"):
        engine.preempt(req.request_id, mode="pause")
    with pytest.raises(ValueError, match="recomputation only"):
        engine.preempt(req.request_id, mode="swap")
    engine.preempt(req.request_id)  # mid-prefill: recompute
    assert req.prefilled_len == 0 and engine.stats.preemptions == 1
    engine.run()
    assert req.status == "finished" and len(req.tokens) == 3
