"""Paged serving port contracts for int8 pages and speculative decoding:
the port's ``ServingEngine`` on the CPU against the JAX package's paged
``ServingEngine`` on the same weights.

Greedy float32 streams must be token-identical to the JAX engine under
both of its attention bodies (the Pallas kernels in interpret mode, and
the XLA gather reference), and the feature counters equal to JAX's:
``kv_dtype="int8"`` (quantize-on-write, in-kernel dequant, a COW clone
of an int8 page with its scale row), ``spec_k`` with a prefix-slice
draft over fp pages, and both together.
"""

import jax
import numpy as np
import pytest

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.serving import Request as JaxRequest
from skycomputing_tpu.serving import ServingEngine as JaxEngine
from skycomputing_tpu.serving import speculative as jspec
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
)
from skycomputing_tpu_torch.serving import Request, ServingEngine
from skycomputing_tpu_torch.serving import speculative as tspec
from skycomputing_tpu_torch.serving.kv_cache import QuantizedPages

pytestmark = pytest.mark.torch_port

BASE = dict(num_slots=3, max_len=48, buckets=(8, 16, 32), page_size=8,
            prefill_batch=2)

COUNTERS = {
    "int8": ("quantized_pages", "dequant_blocks", "cow_copies",
             "prefix_hits"),
    "spec": ("draft_tokens", "accepted_draft_tokens", "spec_rollbacks",
             "decode_tokens"),
}


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


def _batches(seed):
    """Mixed lengths, then two requests that share an 18-token system
    prompt (18 % 8 != 0: the second one's radix hit ends mid-page, so
    a copy-on-write clone)."""
    rng = np.random.default_rng(seed)
    mixed = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
             for n, m in [(5, 7), (3, 4), (12, 6), (7, 1), (16, 5)]]
    system = rng.integers(1, 512, (18,)).astype(np.int32)
    shared = [(np.concatenate(
        [system, rng.integers(1, 512, (t,)).astype(np.int32)]), 5)
        for t in (3, 4)]
    return [mixed, shared[:1], shared[1:]]


def _serve(engine, make_request, batches):
    outs = []
    for batch in batches:
        reqs = [make_request(prompt=p, max_new_tokens=m) for p, m in batch]
        done = engine.run(reqs)
        outs += [done[r.request_id].tolist() for r in reqs]
    return outs


def _against_jax(gpt, attn_impl, counters, **kw):
    layer_cfgs, params, sds = gpt
    batches = _batches(0)
    port = ServingEngine(layer_cfgs, sds, device="cpu", **dict(BASE, **kw))
    ref = JaxEngine(layer_cfgs, params, kv_layout="paged",
                    attn_impl=attn_impl, **dict(BASE, **kw))
    streams = _serve(port, Request, batches)
    assert streams == _serve(ref, JaxRequest, batches)
    snap, jsnap = port.stats.snapshot(), ref.stats.snapshot()
    assert {c: snap[c] for c in counters} == {c: jsnap[c] for c in counters}
    assert snap["finished"] == 7
    port._pool.check_consistency()
    # CPU tensors take the plain versions: no kernel launches
    assert paged_attention.launches == paged_attention_int8.launches == 0
    return port, streams


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_int8_engine_token_identical_to_jax(gpt, attn_impl):
    """(a) int8 pages: identical streams and quantization counters, with
    a COW clone on the int8 pool (values and scale row)."""
    port, _ = _against_jax(gpt, attn_impl, COUNTERS["int8"], kv_dtype="int8")
    snap = port.stats.snapshot()
    assert snap["quantized_pages"] > 0 and snap["dequant_blocks"] > 0
    assert snap["cow_copies"] >= 1 and snap["prefix_hits"] >= 1
    k, v = port.stages[0].slabs[0]
    assert isinstance(k, QuantizedPages) and isinstance(v, QuantizedPages)
    assert port._pool.kv_dtype == "int8"


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_spec_engine_token_identical_to_jax(gpt, attn_impl):
    """(b) speculation over fp pages: identical streams, equal draft /
    accept / rollback counts — and the streams of plain decoding."""
    port, streams = _against_jax(gpt, attn_impl, COUNTERS["spec"],
                                 spec_k=2, draft_blocks=1)
    snap = port.stats.snapshot()
    assert snap["draft_tokens"] > 0 and snap["accepted_draft_tokens"] > 0
    assert snap["spec_ticks"] > 0 and snap["decode_ticks"] == 0
    layer_cfgs, _, sds = gpt
    plain = ServingEngine(layer_cfgs, sds, device="cpu", **BASE)
    assert _serve(plain, Request, _batches(0)) == streams


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_spec_int8_engine_token_identical_to_jax(gpt, attn_impl):
    """(c) speculation over int8 pages: the draft's writes re-quantize
    tail pages in place, and every counter matches JAX's."""
    port, _ = _against_jax(gpt, attn_impl,
                           COUNTERS["spec"] + COUNTERS["int8"],
                           spec_k=2, draft_blocks=1, kv_dtype="int8")
    assert port.stats.accepted_draft_tokens > 0


def test_spec_sampling_rows_commit_one_token(gpt):
    """A temperature request rides the verify forward and commits one
    token per tick from its position-0 logits: its draws equal plain
    decoding's, and it adds nothing to the draft counters."""
    layer_cfgs, _, sds = gpt
    prompt = np.arange(1, 9, dtype=np.int32)

    def run(**kw):
        engine = ServingEngine(layer_cfgs, sds, device="cpu",
                               **dict(BASE, **kw))
        hot = Request(prompt=prompt, max_new_tokens=6, temperature=1.0,
                      seed=3)
        greedy = Request(prompt=prompt + 1, max_new_tokens=6)
        engine.run([hot, greedy])
        return hot.tokens, greedy.tokens, engine.stats

    hot, greedy, stats = run(spec_k=2, draft_blocks=1)
    hot_plain, greedy_plain, _ = run()
    assert (hot, greedy) == (hot_plain, greedy_plain)
    assert stats.draft_tokens <= 6 * 2  # the greedy row's proposals only


def test_speculative_helpers_match_jax(gpt):
    """``greedy_accept_count`` is JAX's; ``tree_param_mb`` counts the
    same bytes as JAX's over the same (converted) parameters."""
    for draft, target in (([1, 2, 3], [1, 2, 4]), ([5, 6], [5, 6]),
                          ([7], [8]), ([], [1])):
        assert tspec.greedy_accept_count(draft, target) == \
            jspec.greedy_accept_count(draft, target)
    _, params, sds = gpt
    assert tspec.tree_param_mb(sds) == pytest.approx(
        jspec.tree_param_mb(jax.device_get(params)))


def test_spec_knob_validation(gpt):
    layer_cfgs, _, sds = gpt
    with pytest.raises(ValueError, match="draft_blocks"):
        ServingEngine(layer_cfgs, sds, device="cpu", spec_k=2, **BASE)
    with pytest.raises(ValueError, match="draft_blocks"):
        ServingEngine(layer_cfgs, sds, device="cpu", spec_k=2,
                      draft_blocks=2, **BASE)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(layer_cfgs, sds, device="cpu", spec_k=-1, **BASE)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(layer_cfgs, sds, device="cpu", kv_dtype="fp8", **BASE)
