"""Multi-stage paged serving port contracts: the port's ``ServingEngine``
placed as several stages (an explicit ``partition`` or an
allocator-written ``worker_manager``) on the CPU, against the JAX
package's multi-stage paged ``ServingEngine`` on the same weights, and
against the port's own one-stage engine.

Greedy float32 streams must be token-identical, with equal
``ServingStats`` counters, over fp and int8 pages, speculative decoding
with the draft inside stage 0, chunked prefill, and swap and recompute
preemption across stages; ``reconfigure`` must accept and reject what
the reference does, leave a rejected engine as it was, and keep streams
identical across every knob class, at one stage and at two.
"""

import jax
import numpy as np
import pytest
import torch

from skycomputing_tpu.analysis.plan_check import PlanError as JaxPlanError
from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.serving import Request as JaxRequest
from skycomputing_tpu.serving import ServingEngine as JaxEngine
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.analysis import PlanError
from skycomputing_tpu_torch.dynamics import WorkerManager
from skycomputing_tpu_torch.serving import Request, ServingEngine
from skycomputing_tpu_torch.serving.engine import (
    _swap_record_checksum,
    _swap_record_nbytes,
)

pytestmark = pytest.mark.torch_port

BASE = dict(num_slots=3, max_len=48, buckets=(8, 16, 32), page_size=8,
            prefill_batch=2)
CPU = [torch.device("cpu")]
# the ServingStats counters both packages keep alike
COUNTERS = ("iterations", "prefill_waves", "prefill_tokens", "decode_tokens",
            "generated_tokens", "admitted", "finished", "preemptions",
            "queue_stalls", "prefix_hits", "prefix_tokens_reused",
            "cow_copies", "swap_outs", "swap_ins", "swap_corruptions",
            "prefill_chunks", "chunk_stalls", "quantized_pages",
            "dequant_blocks", "draft_tokens", "accepted_draft_tokens",
            "spec_rollbacks", "pages_in_use", "free_pages")


@pytest.fixture(scope="module")
def gpt():
    """Tiny GPT, 3 blocks (8 units): JAX params and the port's."""
    cfg = GptConfig(vocab_size=512, hidden_size=64, num_hidden_layers=3,
                    num_attention_heads=2, max_position_embeddings=64,
                    dropout_prob=0.0, dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(7),
                                        np.ones((1, 5), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs)


def _prompts(seed):
    """(prompt, max_new_tokens): mixed lengths (up to 30 tokens: several
    chunks of 8) and two sharing an 18-token prefix (a COW clone)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 512, (18,)).astype(np.int32)
    out = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
           for n, m in [(5, 7), (21, 6), (3, 4), (30, 5), (9, 8)]]
    out += [(np.concatenate([prefix, rng.integers(1, 512, (t,))
                             .astype(np.int32)]), 6) for t in (3, 4)]
    return out


def _drive(engine, make_request, prompts, preempt=None, corrupt=None):
    """Submit everything, step to the end; ``preempt`` = (tick, request
    position, mode) preempts that request before that tick's step, and
    ``corrupt(engine, request_id)`` then poisons its swap record.
    Returns the streams in request order."""
    reqs = [make_request(prompt=p, max_new_tokens=m) for p, m in prompts]
    for r in reqs:
        engine.submit(r)
    tick = 0
    while engine.has_work():
        if preempt is not None and tick == preempt[0]:
            rid = reqs[preempt[1]].request_id
            engine.preempt(rid, mode=preempt[2])
            if corrupt is not None:
                corrupt(engine, rid)
        engine.step()
        tick += 1
    return [r.output().tolist() for r in reqs]


def _counters(engine):
    snap = engine.stats.snapshot()
    return {k: snap[k] for k in COUNTERS}


def _jax_engine(gpt, attn_impl="xla", **kw):
    layer_cfgs, params, _ = gpt
    return JaxEngine(layer_cfgs, params, kv_layout="paged",
                     attn_impl=attn_impl, **dict(BASE, **kw))


def _port_engine(gpt, **kw):
    layer_cfgs, _, sds = gpt
    return ServingEngine(layer_cfgs, sds, devices=CPU, **dict(BASE, **kw))


@pytest.mark.parametrize("attn_impl, kv_dtype", [
    ("xla", None), ("pallas", None), ("xla", "int8")])
def test_two_stages_equal_jax_and_one_stage(gpt, attn_impl, kv_dtype):
    """``partition=[3, 5]``: the streams and every counter equal the JAX
    2-stage engine's; the streams equal the port's 1-stage engine's.
    One page pool and one row ledger serve both stages; each stage holds
    its own attention units' slabs."""
    prompts = _prompts(0)
    port = _port_engine(gpt, partition=[3, 5], kv_dtype=kv_dtype)
    assert [len(st.modules) for st in port.stages] == [3, 5]
    assert [len(st.slabs) for st in port.stages] == [1, 2]
    assert all(st.device == torch.device("cpu") for st in port.stages)
    ref = _jax_engine(gpt, attn_impl, partition=[3, 5], kv_dtype=kv_dtype)
    streams = _drive(port, Request, prompts)
    assert streams == _drive(ref, JaxRequest, prompts)
    assert _counters(port) == _counters(ref)
    assert port.stats.prefix_hits >= 1 and port.stats.cow_copies >= 1
    one = _port_engine(gpt, kv_dtype=kv_dtype)
    assert len(one.stages) == 1
    assert _drive(one, Request, prompts) == streams
    port._pool.check_consistency()


def test_stage_without_attention_and_device_resolution(gpt):
    """A stage may hold no attention unit (no slabs): ``partition=[1, 6,
    1]`` puts the embeddings and the head alone.  Stages land on
    ``devices[k % len(devices)]``; ``device`` is ``devices=[device]``;
    placement errors are the reference's."""
    prompts = _prompts(1)[:4]
    port = _port_engine(gpt, partition=[1, 6, 1])
    assert [len(st.slabs) for st in port.stages] == [0, 3, 0]
    ref = _jax_engine(gpt, partition=[1, 6, 1])
    assert _drive(port, Request, prompts) == _drive(ref, JaxRequest, prompts)
    layer_cfgs, _, sds = gpt
    both = ServingEngine(layer_cfgs, sds, devices=CPU * 2,
                         partition=[4, 4], **BASE)
    assert [st.device for st in both.stages] == CPU * 2
    assert ServingEngine(layer_cfgs, sds, device="cpu",
                         **BASE).device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not cover"):
        _port_engine(gpt, partition=[3, 3])
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(layer_cfgs, sds, device="cpu", devices=CPU, **BASE)
    with pytest.raises(ValueError, match="worker_manager OR partition"):
        _port_engine(gpt, partition=[8], worker_manager=_pool(
            WorkerManager, gpt[0], [8], [10_000.0]))


def _pool(manager_cls, layer_cfgs, counts, limits):
    """A worker pool holding ``counts`` consecutive slices, worker ``i``
    on device ``i`` with ``mem_limit`` ``limits[i]``."""
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"n{i}", device_config=dict(device_index=i),
             extra_config=dict(mem_limit=limit))
        for i, limit in enumerate(limits)
    ])
    cursor = 0
    for w, c in zip(wm.worker_pool, counts):
        w.model_config = layer_cfgs[cursor:cursor + c]
        w.order = w.rank + 1
        cursor += c
    return wm


def test_worker_manager_stages_equal_jax(gpt):
    """Stages from a worker pool (rank order, the verifier's
    ``_stage_workers``): streams and counters equal the JAX engine built
    from an equal pool; an over-budget pool is refused by the pre-flight
    before any slab exists, naming the paged operating point."""
    layer_cfgs, params, sds = gpt
    prompts = _prompts(2)
    counts, roomy = [2, 4, 2], [10_000.0] * 3
    port = ServingEngine(
        layer_cfgs, sds, devices=CPU,
        worker_manager=_pool(WorkerManager, layer_cfgs, counts, roomy),
        **BASE)
    assert [len(st.modules) for st in port.stages] == counts
    ref = JaxEngine(
        layer_cfgs, params, kv_layout="paged", attn_impl="xla",
        worker_manager=_pool(JaxWorkerManager, layer_cfgs, counts, roomy),
        **BASE)
    assert _drive(port, Request, prompts) == _drive(ref, JaxRequest, prompts)
    assert _counters(port) == _counters(ref)

    tight = [0.05] * 3
    with pytest.raises(PlanError) as got:
        ServingEngine(
            layer_cfgs, sds, devices=CPU,
            worker_manager=_pool(WorkerManager, layer_cfgs, counts, tight),
            **BASE)
    with pytest.raises(JaxPlanError) as want:
        JaxEngine(
            layer_cfgs, params, kv_layout="paged", attn_impl="xla",
            worker_manager=_pool(JaxWorkerManager, layer_cfgs, counts,
                                 tight), **BASE)
    assert "KV pages" in str(got.value)
    assert [(i.code, i.severity, i.message) for i in got.value.issues] == [
        (i.code, i.severity, i.message) for i in want.value.issues]
    # the opt-out builds the same plan unchecked
    ServingEngine(
        layer_cfgs, sds, devices=CPU, preflight=False,
        worker_manager=_pool(WorkerManager, layer_cfgs, counts, tight),
        **BASE)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_two_stage_speculative_equals_jax(gpt, kv_dtype):
    """``spec_k=2, draft_blocks=1`` with the draft's 3 layers inside
    stage 0 of ``partition=[3, 5]``: streams and the speculation
    counters equal the JAX 2-stage engine's and the plain streams; the
    head's MB is charged to stage 0 as the reference charges it, though
    the stages share one device and no copy is made."""
    prompts = _prompts(3)
    kw = dict(partition=[3, 5], spec_k=2, draft_blocks=1, kv_dtype=kv_dtype)
    port = _port_engine(gpt, **kw)
    ref = _jax_engine(gpt, **kw)
    streams = _drive(port, Request, prompts)
    assert streams == _drive(ref, JaxRequest, prompts)
    assert _counters(port) == _counters(ref)
    assert port.stats.spec_ticks > 0 and port.stats.draft_tokens > 0
    assert port._draft_mb > 0
    assert port._draft_mb == pytest.approx(ref._draft_mb, rel=1e-12)
    assert port._serving_context()["draft_mb"] == port._draft_mb
    assert port._draft.modules[-1] is port.stages[-1].modules[-1]
    assert _drive(_port_engine(gpt, kv_dtype=kv_dtype), Request,
                  prompts) == streams
    with pytest.raises(ValueError, match="resident on stage 0") as got:
        _port_engine(gpt, partition=[2, 6], spec_k=2, draft_blocks=1)
    with pytest.raises(ValueError) as want:
        _jax_engine(gpt, partition=[2, 6], spec_k=2, draft_blocks=1)
    assert str(got.value) == str(want.value)


def test_two_stage_chunked_prefill_equals_jax(gpt):
    prompts = _prompts(4)
    kw = dict(partition=[4, 4], prefill_chunk=8)
    port = _port_engine(gpt, **kw)
    ref = _jax_engine(gpt, **kw)
    streams = _drive(port, Request, prompts)
    assert streams == _drive(ref, JaxRequest, prompts)
    assert _counters(port) == _counters(ref)
    assert port.stats.prefill_chunks > len(prompts)
    assert _drive(_port_engine(gpt), Request, prompts) == streams


@pytest.mark.parametrize("mode, kv_dtype", [
    ("swap", None), ("recompute", None), ("swap", "int8")])
def test_two_stage_preemption_equals_jax(gpt, mode, kv_dtype):
    """Preempting the same request at the same tick: streams equal the
    JAX 2-stage engine's and the un-preempted run's, counters equal; a
    swap record nests per stage (stages -> layers -> (k, v)) and its
    checksum verifies over every stage's host copies."""
    prompts = _prompts(5)
    kw = dict(partition=[3, 5], kv_dtype=kv_dtype)
    clean = _drive(_port_engine(gpt, **kw), Request, prompts)
    plan = (4, 0, mode)
    port = _port_engine(gpt, **kw)
    records = []
    preempt = port.preempt

    def preempt_and_keep(request_id, mode=None):
        out = preempt(request_id, mode=mode)
        records.append(port._swapped.get(request_id))
        return out

    port.preempt = preempt_and_keep
    streams = _drive(port, Request, prompts, preempt=plan)
    assert streams == _drive(_jax_engine(gpt, **kw), JaxRequest, prompts,
                             preempt=plan) == clean
    assert port.stats.preemptions == 1
    assert port.stats.swap_ins == port.stats.swap_outs == (mode == "swap")
    record, = records
    if mode == "swap":
        assert [len(stage) for stage in record["data"]] == [1, 2]
        assert record["checksum"] == _swap_record_checksum(
            record["pages"], record["index"], record["data"])
        assert record["nbytes"] == _swap_record_nbytes(record["data"]) > 0
    else:
        assert record is None
    port._pool.check_consistency()


def test_two_stage_corrupt_swap_falls_back_as_jax(gpt):
    """A swap record whose stage-0 bytes rot while parked (the
    reference's ``corrupt_swap_record``: the first byte of stage 0's
    first K copy flipped) fails its checksum at swap-in in both
    packages: dropped, counted, resumed by recomputation, streams
    intact."""
    prompts = _prompts(6)

    def rot_port(engine, rid):
        k_host, _ = engine._swapped[rid]["data"][0][0]
        k_host.view(torch.uint8).view(-1)[0] ^= 0xFF

    def rot_jax(engine, rid):
        assert engine.corrupt_swap_record(rid) == rid

    plan = (4, 1, "swap")
    port = _port_engine(gpt, partition=[3, 5])
    ref = _jax_engine(gpt, partition=[3, 5])
    streams = _drive(port, Request, prompts, preempt=plan, corrupt=rot_port)
    assert streams == _drive(ref, JaxRequest, prompts, preempt=plan,
                             corrupt=rot_jax)
    assert _counters(port) == _counters(ref)
    assert port.stats.swap_corruptions == 1 and port.stats.swap_ins == 0
    assert streams == _drive(_port_engine(gpt), Request, prompts)


# --- reconfigure: the reference's two contracts, replayed -------------------


def _outcome(call, reqs=()):
    """(exception type name, message) of ``call()``, or None; a request
    the message names is named by its position in ``reqs`` (ids count
    per package)."""
    try:
        call()
    except (PlanError, JaxPlanError, ValueError) as exc:
        msg = str(exc)
        for i, r in enumerate(reqs):
            msg = msg.replace(f"request {r.request_id} ", f"request #{i} ")
        return type(exc).__name__, msg
    return None


def _replay(engines, script):
    """Run ``script`` (a list of ('step', n) / ('reconfigure', knobs) /
    ('submit', prompts)) on each (engine, Request class); returns per
    engine the outcome of every reconfigure and the requests."""
    results = []
    for engine, make_request in engines:
        outcomes, reqs = [], []
        for op, arg in script:
            if op == "submit":
                for p, m in arg:
                    reqs.append(engine.submit(
                        make_request(prompt=p, max_new_tokens=m)))
            elif op == "step":
                for _ in range(arg):
                    engine.step()
            elif op == "reconfigure":
                outcomes.append(_outcome(
                    lambda: engine.reconfigure(**arg), reqs))
                outcomes.append((engine.num_pages, engine.max_concurrency,
                                 engine.prefill_chunk, engine.spec_k,
                                 tuple(engine.bucketer.buckets)))
            elif op == "run":
                engine.run()
        results.append((outcomes, [r.output().tolist() for r in reqs],
                        _counters(engine)))
    return results


def _same_outcomes(port, ref):
    """Equal outcomes: exception type names differ only by package
    (``PlanError`` in both), messages equal."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a == b


@pytest.mark.parametrize("partition", [None, [3, 5]],
                         ids=["1-stage", "2-stage"])
def test_paged_reconfigure_verify_then_apply(gpt, partition):
    """The reference's contract, replayed: bucket-only changes evict
    nothing; a concurrency change evicts recomputation-style on the same
    pool; a geometry change rebuilds pool and every stage's slabs with
    counters banked; an infeasible point is rejected with the engine
    untouched.  Outcomes, streams and counters equal the JAX engine's."""
    rng = np.random.default_rng(16)
    first = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
             for n, m in [(5, 8), (3, 6), (6, 9)]]
    script = [("submit", first), ("step", 3),
              ("reconfigure", dict(buckets=(8, 16, 32))),
              ("reconfigure", dict(max_concurrency=6)), ("step", 1),
              ("reconfigure", dict(num_pages=12)),
              ("reconfigure", dict(max_pages_per_request=100)),
              ("reconfigure", dict(num_slots=4, max_concurrency=5)),
              ("reconfigure", dict(buckets=(4,))), ("run", None)]
    kw = dict(max_concurrency=4, buckets=(8, 16))
    if partition:
        kw["partition"] = partition
    port = _port_engine(gpt, **kw)
    ref = _jax_engine(gpt, **kw)
    (p_out, p_streams, p_counts), (j_out, j_streams, j_counts) = _replay(
        [(port, Request), (ref, JaxRequest)], script)
    _same_outcomes(p_out, j_out)
    assert p_streams == j_streams
    assert p_counts == j_counts
    assert p_out[0] is None and p_out[2] is None  # buckets, rows applied
    assert p_out[6][0] == "PlanError"  # max_pages_per_request 100 > 12
    assert p_out[7] == (12, 6, None, 0, (8, 16, 32))  # untouched
    assert p_counts["preemptions"] > 0
    assert port.num_pages == 12 and len(port.stages[-1].slabs[0][0]) == 12
    port._pool.check_consistency()


@pytest.mark.parametrize("partition", [None, [3, 5]],
                         ids=["1-stage", "2-stage"])
def test_chunk_spec_reconfigure_verify_then_apply(gpt, partition):
    """The chunk and speculation knobs ride the same verify-then-apply:
    an off-bucket chunk or a malformed ``spec_k`` is rejected with the
    engine untouched; enabling both and disabling both apply with live
    requests, and disabling chunking re-queues mid-prefill requests.
    Outcomes, streams and counters equal the JAX engine's."""
    rng = np.random.default_rng(26)
    first = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
             for n, m in [(5, 10), (12, 8)]]
    more = [(rng.integers(1, 512, (n,)).astype(np.int32), m)
            for n, m in [(14, 6), (6, 5)]]
    script = [("submit", first), ("step", 2),
              ("reconfigure", dict(prefill_chunk=5)),
              ("reconfigure", dict(spec_k=-1)),
              ("reconfigure", dict(max_chunk_rows=4)),
              ("reconfigure", dict(prefill_chunk=8, spec_k=2)),
              ("submit", more), ("step", 1),
              ("reconfigure", dict(prefill_chunk=0, spec_k=0)),
              ("run", None)]
    kw = dict(buckets=(8, 16), draft_blocks=1)
    if partition:
        kw["partition"] = partition
    port = _port_engine(gpt, **kw)
    ref = _jax_engine(gpt, **kw)
    (p_out, p_streams, p_counts), (j_out, j_streams, j_counts) = _replay(
        [(port, Request), (ref, JaxRequest)], script)
    _same_outcomes(p_out, j_out)
    assert p_streams == j_streams and p_counts == j_counts
    assert [o[0] for o in p_out[0:6:2]] == ["PlanError", "PlanError",
                                            "ValueError"]
    assert p_out[6] is None and p_out[7][2:4] == (8, 2)
    assert p_out[8] is None and p_out[9][2:4] == (None, 0)
    assert not port._prefilling
    no_draft = _port_engine(gpt)
    assert _outcome(lambda: no_draft.reconfigure(spec_k=2)) == _outcome(
        lambda: _jax_engine(gpt).reconfigure(spec_k=2))
    assert no_draft.spec_k == 0 and no_draft._draft is None
    port._pool.check_consistency()


def test_reconfigure_spec_enable_charges_draft_memory(gpt):
    """Turning speculation on at two stages makes the draft's head charge
    newly resident on stage 0: the pre-flight charges it before the draft
    exists, so a budget that fits the slabs but not the head refuses the
    change with the engine untouched (the reference's contract and
    diagnostic); with headroom the same change applies."""
    layer_cfgs, params, sds = gpt

    def build(pkg, limit0):
        manager, engine, extra = (
            (WorkerManager, ServingEngine, dict(devices=CPU, params=sds))
            if pkg == "port" else
            (JaxWorkerManager, JaxEngine, dict(kv_layout="paged",
                                               attn_impl="xla",
                                               params=params)))
        wm = _pool(manager, layer_cfgs, [3, 5], [limit0, 10_000.0])
        p = extra.pop("params")
        return engine(layer_cfgs, p, num_slots=2, max_len=32, buckets=(8,),
                      worker_manager=wm, page_size=8, draft_blocks=1,
                      **extra)

    port, ref = build("port", 0.74), build("jax", 0.74)
    assert port._pending_draft_mb() > 0.1
    assert port._pending_draft_mb() == pytest.approx(
        ref._pending_draft_mb(), rel=1e-12)
    got = _outcome(lambda: port.reconfigure(spec_k=2))
    assert got == _outcome(lambda: ref.reconfigure(spec_k=2))
    assert got[0] == "PlanError" and "speculative draft" in got[1]
    assert port.spec_k == 0 and port._draft is None
    roomy = build("port", 10_000.0)
    roomy.reconfigure(spec_k=2)
    assert roomy.spec_k == 2 and roomy._draft_mb > 0
    assert roomy._draft_mb == roomy._draft.extra_param_mb
