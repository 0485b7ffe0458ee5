"""Slot-layout serving and the one-shot references, port against JAX.

On the CPU and the same weights (``params_from_jax``): the port's
``generate`` and ``generate_cached`` give the JAX functions' greedy
tokens; the port's slot ``ServingEngine`` (the default layout, as in the
reference) gives the JAX slot engine's streams with equal counters
through mixed-length waves, slot exhaustion, ``static_batching`` (on
both layouts), recompute preemption and a slot ``reconfigure``;
``SlotKVCachePool`` keeps the reference's contract.  The paged knobs
the bench uses (``gather_pages``, ``attn_impl``) are held here too.
"""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.analysis.plan_check import PlanError as JaxPlanError
from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.models.gpt import generate as jax_generate
from skycomputing_tpu.models.gpt import generate_cached as jax_cached
from skycomputing_tpu.serving import KVCacheSpec as JaxSpec
from skycomputing_tpu.serving import Request as JaxRequest
from skycomputing_tpu.serving import ServingEngine as JaxEngine
from skycomputing_tpu.serving import SlotKVCachePool as JaxPool
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.analysis import PlanError
from skycomputing_tpu_torch.builder import build_layer_stack
from skycomputing_tpu_torch.dynamics import WorkerManager
from skycomputing_tpu_torch.models.gpt import (
    CachedGptDecoder,
    generate,
    generate_cached,
    one_shot_forward,
)
from skycomputing_tpu_torch.ops.paged_attention import paged_attention
from skycomputing_tpu_torch.serving import (
    KVCacheSpec,
    Request,
    ServingEngine,
    SlotKVCachePool,
    init_layer_caches,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


BASE = dict(num_slots=3, max_len=48, buckets=(8, 16, 32), prefill_batch=2)
# the ServingStats counters both packages keep alike on a slot engine
COUNTERS = ("iterations", "prefill_waves", "prefill_tokens", "decode_tokens",
            "generated_tokens", "admitted", "finished", "preemptions",
            "queue_stalls", "queue_rejections", "batch_occupancy",
            "queue_depth")


@pytest.fixture(scope="module")
def gpt():
    cfg = GptConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=64,
                    dropout_prob=0.0, dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    stack = jax_build(layer_cfgs)
    params = stack.init(jax.random.key(7), np.ones((1, 5), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs), stack


def _prompts(seed, spec=((5, 7), (3, 4), (12, 6), (7, 1), (16, 5),
                         (22, 3), (9, 8))):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 512, (n,)).astype(np.int32), m)
            for n, m in spec]


def _drive(engine, make_request, prompts, actions=()):
    """Submit everything, step to the end; ``actions`` = [(tick, fn)]
    calls ``fn(engine, requests)`` before that tick's step.  Returns the
    streams in request order."""
    reqs = [make_request(prompt=p, max_new_tokens=m) for p, m in prompts]
    for r in reqs:
        engine.submit(r)
    todo = dict(actions)
    tick = 0
    while engine.has_work():
        if tick in todo:
            todo[tick](engine, reqs)
        engine.step()
        tick += 1
    return [r.output().tolist() for r in reqs]


def _counters(engine):
    snap = engine.stats.snapshot()
    return {k: snap[k] for k in COUNTERS}


def _port(gpt, **kw):
    layer_cfgs, _, sds, _ = gpt
    return ServingEngine(layer_cfgs, sds, device="cpu", **dict(BASE, **kw))


def _jax(gpt, **kw):
    layer_cfgs, params, _, _ = gpt
    return JaxEngine(layer_cfgs, params, **dict(BASE, **kw))


# --- the one-shot references ----------------------------------------------


def _port_stack(gpt):
    layer_cfgs, _, sds, _ = gpt
    stack = build_layer_stack(layer_cfgs)
    for module, sd in zip(stack.layers, sds):
        module.load_state_dict(sd)
    return stack


@pytest.mark.parametrize("new_tokens", [9, 1])
def test_generate_and_cached_equal_jax(gpt, new_tokens):
    """Greedy: the port's full-forward ``generate`` and its KV-cache
    ``generate_cached`` both give the JAX ``generate``'s tokens (which
    JAX's own ``generate_cached`` gives too)."""
    layer_cfgs, params, sds, stack = gpt
    prompt = np.random.default_rng(3).integers(1, 512, (2, 5)).astype(
        np.int32)
    fwd = jax.jit(lambda ids: stack.apply(params, ids))
    want = jax_generate(fwd, prompt, max_new_tokens=new_tokens,
                        context_length=32)
    np.testing.assert_array_equal(
        jax_cached(stack, params, prompt, new_tokens, 32), want)
    got = generate(one_shot_forward(layer_cfgs, sds, device="cpu"), prompt,
                   max_new_tokens=new_tokens, context_length=32)
    np.testing.assert_array_equal(got, want)
    cached = generate_cached(_port_stack(gpt), prompt,
                             max_new_tokens=new_tokens, context_length=32)
    np.testing.assert_array_equal(cached, want)
    assert got.dtype == cached.dtype == np.int32


def test_sampled_generate_matches_cached_and_edges(gpt):
    """Sampling draws from an explicit ``torch.Generator``: the same
    seed gives ``generate`` and ``generate_cached`` the same tokens, and
    another seed other tokens.  Zero new tokens return the prompt; a
    context past the position table and an overlong request raise."""
    layer_cfgs, _, sds, _ = gpt
    prompt = np.random.default_rng(4).integers(1, 512, (2, 5)).astype(
        np.int32)
    fwd = one_shot_forward(layer_cfgs, sds, device="cpu")
    stack = _port_stack(gpt)

    def draw(fn, target, seed):
        return fn(target, prompt, 9, 32, temperature=0.8,
                  generator=torch.Generator().manual_seed(seed))

    full = draw(generate, fwd, 11)
    np.testing.assert_array_equal(draw(generate_cached, stack, 11), full)
    assert not np.array_equal(draw(generate, fwd, 12), full)
    np.testing.assert_array_equal(generate_cached(stack, prompt, 0, 32),
                                  prompt)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate_cached(stack, prompt, 4, 65)
    with pytest.raises(ValueError, match="context_length"):
        generate(fwd, prompt, 30, 32)
    decoder = CachedGptDecoder(stack)
    caches = decoder.init_cache(2, 16)
    assert len(caches) == 2 and caches[0][0].shape == (2, 16, 2, 32)


# --- the slot pool ----------------------------------------------------------


def test_slot_pool_contract():
    """The reference's contract (``tests/test_serving.py``): allocate
    until None, release, double release, the multi-stage acquire, one
    (k, v) pair per layer, ``total_mb`` equal to JAX's."""
    spec = KVCacheSpec(max_len=16, num_heads=2, head_dim=4)
    pool = SlotKVCachePool([spec, spec], slots=2)
    assert pool.free_slots == 2 and pool.occupancy == 0.0
    a, b = pool.allocate(), pool.allocate()
    assert {a, b} == {0, 1}
    assert pool.allocate() is None
    assert pool.occupancy == 1.0
    pool.release(a)
    with pytest.raises(ValueError, match="double-released"):
        pool.release(a)
    pool.acquire(a)
    with pytest.raises(ValueError, match="not free"):
        pool.acquire(a)
    with pytest.raises(ValueError, match="out of range"):
        pool.release(5)
    with pytest.raises(ValueError, match="at least 1 slot"):
        SlotKVCachePool([spec], slots=0)
    assert len(pool.slabs) == 2
    assert tuple(pool.slabs[0][0].shape) == (2, 16, 2, 4)
    ref = JaxPool([JaxSpec(max_len=16, num_heads=2, head_dim=4)] * 2,
                  slots=2)
    assert pool.total_mb() == pytest.approx(ref.total_mb(), rel=1e-12)
    assert pool.total_mb() == pytest.approx(2 * spec.slab_mb(2))
    # the LIFO free list hands out ids in the reference's order
    fresh, jax_fresh = (cls([s], slots=3) for cls, s in (
        (SlotKVCachePool, spec), (JaxPool, JaxSpec(16, 2, 4))))
    fresh.release(fresh.allocate())
    jax_fresh.release(jax_fresh.allocate())
    assert [fresh.allocate() for _ in range(3)] == [
        jax_fresh.allocate() for _ in range(3)]
    caches = init_layer_caches([spec], 3)
    assert caches[0][0].dtype == torch.float32
    assert float(caches[0][1].abs().sum()) == 0.0


# --- the slot engine against the JAX slot engine -------------------------


@pytest.mark.parametrize("case, kw, spec", [
    ("mixed_waves", {}, None),
    ("exhaustion_queues", dict(num_slots=2, prefill_batch=1), None),
    ("two_stages", dict(partition=[3, 3]), None),
    ("wide_waves", dict(num_slots=6, prefill_batch=4),
     ((4, 5), (6, 3), (2, 7), (8, 2), (14, 6), (11, 4))),
])
def test_slot_engine_token_identical_to_jax(gpt, case, kw, spec):
    """Streams and counters equal the JAX slot engine's: mixed-length
    waves, a pool of 2 slots with 7 requests (queueing on exhaustion),
    two stages, 4-row waves.  No paged-attention kernel or plain version
    serves the slot layout."""
    prompts = _prompts(0) if spec is None else _prompts(5, spec)
    port, ref = _port(gpt, **kw), _jax(gpt, **kw)
    assert port.kv_layout == "slot" and port.attn_impl is None
    assert _drive(port, Request, prompts) == _drive(ref, JaxRequest, prompts)
    assert _counters(port) == _counters(ref)
    assert port.stats.finished == len(prompts)
    if case == "exhaustion_queues":
        assert port.stats.queue_stalls > 0
    assert port.free_slots == port.num_slots
    assert all(st.pool.free_slots == port.num_slots for st in port.stages)
    assert paged_attention.launches == 0


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_static_batching_equals_jax(gpt, layout):
    """``static_batching=True`` admits only at batch boundaries, on both
    layouts: streams and counters equal the JAX engine's, the streams
    equal continuous batching's, and it takes more iterations."""
    # short and long generations mixed: a static batch waits for its
    # slowest member
    prompts = _prompts(1, ((5, 9), (3, 3), (7, 3), (6, 9), (4, 9), (2, 3),
                           (6, 2)))
    kw = dict(static_batching=True)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8, max_concurrency=3)
    port = _port(gpt, **kw)
    ref = _jax(gpt, **(dict(kw, attn_impl="xla") if layout == "paged"
                      else kw))
    streams = _drive(port, Request, prompts)
    assert streams == _drive(ref, JaxRequest, prompts)
    assert _counters(port) == _counters(ref)
    cont = _port(gpt, **dict(kw, static_batching=False))
    assert _drive(cont, Request, prompts) == streams
    assert port.stats.iterations > cont.stats.iterations


def test_recompute_preemption_equals_jax(gpt):
    """A slot engine preempts by recomputation only: the victim re-queues
    at the head, re-prefills its effective prompt and finishes with the
    un-preempted stream; streams and counters equal JAX's.  Swap mode
    raises and leaves the request running."""
    prompts = _prompts(2)

    def preempt(engine, reqs):
        engine.preempt(reqs[0].request_id)

    port, ref = _port(gpt), _jax(gpt)
    streams = _drive(port, Request, prompts, [(2, preempt)])
    assert streams == _drive(ref, JaxRequest, prompts, [(2, preempt)])
    assert _counters(port) == _counters(ref)
    assert port.stats.preemptions == 1
    assert streams == _drive(_port(gpt), Request, prompts)

    engine = _port(gpt)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in prompts[:2]]
    engine.run()
    for r in reqs:
        engine.submit(r)
    engine.step()
    with pytest.raises(ValueError, match="recomputation"):
        engine.preempt(reqs[0].request_id, mode="swap")
    assert reqs[0].request_id in {r.request_id
                                  for r in engine.running_requests}
    with pytest.raises(KeyError):
        engine.preempt(12345)


@pytest.mark.parametrize("slots", [5, 2])
def test_slot_reconfigure_equals_jax(gpt, slots):
    """``reconfigure(num_slots=...)`` up and down mid-run (with a new
    bucket set and wave width): every stage's pool is rebuilt, the
    running batch re-seats by recomputation, streams and counters equal
    JAX's and the unreconfigured streams; page knobs raise; a request
    that fits no new bucket rejects the change and leaves the engine as
    it was."""
    prompts = _prompts(3)
    knobs = dict(num_slots=slots, buckets=(8, 16, 32, 48), prefill_batch=1)

    def change(engine, reqs):
        engine.reconfigure(**knobs)

    port, ref = _port(gpt, partition=[2, 4]), _jax(gpt, partition=[2, 4])
    streams = _drive(port, Request, prompts, [(2, change)])
    assert streams == _drive(ref, JaxRequest, prompts, [(2, change)])
    assert _counters(port) == _counters(ref)
    assert port.num_slots == slots and port.stats.preemptions > 0
    assert all(st.pool.num_slots == slots for st in port.stages)
    assert streams == _drive(_port(gpt), Request, prompts)

    with pytest.raises(ValueError, match="require kv_layout='paged'"):
        port.reconfigure(num_pages=8)
    engine = _port(gpt)
    engine.submit(Request(prompt=np.arange(1, 23, dtype=np.int32),
                          max_new_tokens=2))
    with pytest.raises(ValueError, match="cannot resume"):
        engine.reconfigure(buckets=(8, 16), num_slots=2)
    assert engine.num_slots == 3 and engine.bucketer.buckets == (8, 16, 32)


def test_slot_preflight_equals_jax(gpt):
    """A worker pool whose slot slabs outgrow its budgets is refused
    before any slab exists, with the JAX verifier's issues."""
    layer_cfgs, params, sds, _ = gpt

    def pool(manager_cls, limit):
        wm = manager_cls()
        wm.load_worker_pool_from_config([
            dict(name=f"n{i}", device_config=dict(device_index=i),
                 extra_config=dict(mem_limit=limit)) for i in range(2)])
        for i, w in enumerate(wm.worker_pool):
            w.model_config = layer_cfgs[3 * i:3 * i + 3]
            w.order = w.rank + 1
        return wm

    kw = dict(num_slots=64, max_len=64, buckets=(8,))
    with pytest.raises(PlanError) as got:
        ServingEngine(layer_cfgs, sds, devices=[torch.device("cpu")],
                      worker_manager=pool(WorkerManager, 0.05), **kw)
    with pytest.raises(JaxPlanError) as want:
        JaxEngine(layer_cfgs, params,
                  worker_manager=pool(JaxWorkerManager, 0.05), **kw)
    assert "KV slots" in str(got.value)
    assert [(i.code, i.severity, i.message) for i in got.value.issues] == [
        (i.code, i.severity, i.message) for i in want.value.issues]
    engine = ServingEngine(layer_cfgs, sds, devices=[torch.device("cpu")],
                           worker_manager=pool(WorkerManager, 10_000.0),
                           **kw)
    assert [len(st.modules) for st in engine.stages] == [3, 3]


# --- the paged knobs the bench uses ---------------------------------------


@pytest.mark.parametrize("gather", ["full", "live"])
def test_gather_pages_and_plain_equal_jax(gpt, gather):
    """``gather_pages`` sizes each step's table as JAX's does, and both
    widths give JAX's streams; ``attn_impl="plain"`` runs the plain
    version by request and gives the same streams as the default (which
    on the CPU is the plain version too)."""
    prompts = _prompts(4)
    kw = dict(kv_layout="paged", page_size=8, gather_pages=gather,
              max_pages_per_request=6, num_pages=18)
    port = _port(gpt, **kw)
    assert port.attn_impl == "plain"
    streams = _drive(port, Request, prompts)
    assert streams == _drive(_jax(gpt, attn_impl="xla", **kw), JaxRequest,
                             prompts)
    # the live width's floor is the largest bucket's span, 4 pages
    assert port._table_width(np.array([3])) == (6 if gather == "full" else 4)
    plain = _port(gpt, attn_impl="plain", **kw)
    assert plain.stages[0].plain and not port.stages[0].plain
    assert _drive(plain, Request, prompts) == streams


@pytest.mark.parametrize("kwargs, match", [
    (dict(kv_layout="paged", attn_impl="kernel"), "CUDA device"),
    (dict(kv_layout="paged", attn_impl="xla"), "attn_impl must be"),
    (dict(kv_layout="paged", gather_pages="some"), "gather_pages must be"),
    (dict(kv_layout="ring"), "kv_layout must be"),
    (dict(kv_dtype="int8"), "require kv_layout='paged'"),
    (dict(attn_impl="plain"), "require kv_layout='paged'"),
    (dict(gather_pages="full"), "require kv_layout='paged'"),
    (dict(prefill_chunk=8), "prefill_chunk requires"),
    (dict(spec_k=2, draft_blocks=1), "spec_k requires"),
])
def test_layout_knobs_raise(gpt, kwargs, match):
    """The reference's refusals: paged machinery on a slot engine, an
    unknown layout or knob value; and the port's own: the kernel asked
    for where no stage is on the card."""
    with pytest.raises(ValueError, match=match):
        _port(gpt, **kwargs)
