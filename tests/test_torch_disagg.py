"""The port's disaggregated serving (``disagg/``, the engine's handoff
plane, ``plan_check.verify_handoff_payload``) against the JAX package's
on one tiny GPT (``tests/test_disagg.py``'s: 2 blocks, hidden 64; the
JAX weights converted), the port on the CPU through its plain versions.

Exact, case for case: every malformed ``HandoffRecord`` refused with
JAX's message, the ledger's state machine (events, audit, snapshot,
refusals), both checksum functions' hex over the same host bytes
(float32 pages and int8 ``QuantizedPages``), ``verify_handoff_payload``'s
problem lists; the engine's export -> import and ``corrupt_swap_record``
(streams, the handoff and swap counters, the exporting engine left
holding nothing of the request); and ``DisaggFleet`` on
``tests/test_disagg.py``'s five scenarios (streams against JAX's fleet
and the port's one-shot ``generate``, the ledger's events, states and
reasons, the fleet counters).  Host timing stays out of the compared
decisions as ``tests/torch_fleet_helpers.py`` says."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from skycomputing_tpu import disagg as jax_disagg
from skycomputing_tpu.analysis import plan_check as jax_plan_check
from skycomputing_tpu.serving import engine as jax_engine
from skycomputing_tpu.serving.kv_cache import QuantizedPages as JaxQP
from skycomputing_tpu_torch import disagg as port_disagg
from skycomputing_tpu_torch.analysis import plan_check as port_plan_check
from skycomputing_tpu_torch.serving import engine as port_engine
from skycomputing_tpu_torch.serving.kv_cache import QuantizedPages as PortQP
from skycomputing_tpu_torch.tools import bench_disagg
from torch_fleet_helpers import (
    depth_router,
    port_generate_identity,
    sides,
    stdlib_load,
    streams,
    tiny_gpt,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

_HEX = "ab" * 32
DISAGG = {"jax": jax_disagg, "port": port_disagg}


@pytest.fixture(scope="module")
def gpt():
    return tiny_gpt()


def _record(mod, rid=0, **over):
    fields = dict(
        request_id=rid, source="replica0", prompt_len=8, prefilled_len=9,
        index=9, pages=2, checksum=_HEX, slab_checksums=(_HEX, _HEX),
        page_size=8, max_pages_per_request=4, stages=2,
        kv_dtype="float32", tick=3)
    fields.update(over)
    return mod.HandoffRecord(**fields)


def _outcome(fn):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 - the comparison is the point
        return type(exc).__name__, str(exc)


# --------------------------------------------------------------------------
# the record and ledger contract (pure host logic)
# --------------------------------------------------------------------------

RECORD_NEGATIVES = [
    dict(request_id=-1), dict(source=""), dict(prompt_len=0),
    dict(prefilled_len=7), dict(pages=9), dict(index=99),
    dict(checksum="abc"), dict(checksum=_HEX.upper()),
    dict(slab_checksums=(_HEX,)), dict(slab_checksums=[_HEX, _HEX]),
    dict(kv_dtype=""), dict(tick=-2), dict(request_id=True),
]


@pytest.mark.parametrize("over", RECORD_NEGATIVES,
                         ids=[next(iter(o)) + str(i)
                              for i, o in enumerate(RECORD_NEGATIVES)])
def test_handoff_record_refusals_equal_jax(over):
    ours = _outcome(lambda: _record(port_disagg, **over))
    assert ours[0] == "ValueError"
    assert ours == _outcome(lambda: _record(jax_disagg, **over))


def test_handoff_record_views_equal_jax():
    ours, theirs = _record(port_disagg), _record(jax_disagg)
    assert ours.key() == theirs.key()
    assert ours.to_dict() == theirs.to_dict()


def _ledger_story(mod):
    """tests/test_disagg.py's ledger sequence, every refusal's message
    and every view recorded."""
    led = mod.HandoffLedger()
    seen = [_outcome(lambda: led.enqueue("not a record"))]
    for rid, src in ((1, "replica0"), (2, "replica0"), (3, "replica1")):
        led.enqueue(_record(mod, rid=rid, source=src))
    seen.append(_outcome(lambda: led.enqueue(_record(mod, rid=1))))
    seen.append((led.state_of(1), led.state_of(99)))
    seen.append(_outcome(lambda: led.mark_failed(1, "")))
    led.mark_delivered(1, target="replica2")
    seen.append(_outcome(lambda: led.mark_delivered(1)))
    led.mark_failed(2, "source died mid-handoff")
    seen.append(_outcome(lambda: led.mark_failed(2, "again")))
    seen.append(_outcome(lambda: led.mark_delivered(7)))
    led.mark_failed(1, "checksum mismatch")  # delivered -> failed
    seen.append([r.request_id for r in led.pending_for("replica1")])
    seen.append(led.pending_for("replica0"))
    seen.append(led.counts())
    seen.append((led.reason(2), led.record(3).key()))
    return seen, led.events, led.audit(), led.snapshot()


def test_handoff_module_is_stdlib_only():
    """``disagg/handoff.py`` loads by file path with torch, numpy and
    jax blocked, and its ledger tells the same story there."""
    path = Path(port_disagg.__file__).parent / "handoff.py"
    got = stdlib_load(path, "(lambda led: [led.enqueue(mod.HandoffRecord("
                      "request_id=1, source='r0', prompt_len=8, "
                      "prefilled_len=9, index=9, pages=2, checksum='ab' * 32,"
                      " slab_checksums=('ab' * 32,), page_size=8, "
                      "max_pages_per_request=4, stages=1, kv_dtype='f32')),"
                      " led.mark_failed(1, 'why'), led.audit()][-1])("
                      "mod.HandoffLedger())")
    led = jax_disagg.HandoffLedger()
    led.enqueue(jax_disagg.HandoffRecord(
        request_id=1, source="r0", prompt_len=8, prefilled_len=9, index=9,
        pages=2, checksum=_HEX, slab_checksums=(_HEX,), page_size=8,
        max_pages_per_request=4, stages=1, kv_dtype="f32"))
    led.mark_failed(1, "why")
    assert got == json.loads(json.dumps(led.audit()))


def test_handoff_ledger_equals_jax():
    ours = _ledger_story(port_disagg)
    assert ours == _ledger_story(jax_disagg)
    audit = ours[2]
    assert audit["conservation_ok"] and audit["failed"] == 2
    assert audit["failed_reasons"] == {"source died mid-handoff": 1,
                                       "checksum mismatch": 1}


# --------------------------------------------------------------------------
# checksums over the same host bytes
# --------------------------------------------------------------------------


def _host_payload(int8: bool, stages=2, layers=2, rows=4, page=8, heads=2,
                  dim=16):
    """(JAX payload, port payload) over the same bytes: stages ->
    per-layer (k, v) -> an array, or values + scale."""
    rng = np.random.default_rng(5 + int8)
    jax_data, port_data = [], []
    for _ in range(stages):
        jpairs, ppairs = [], []
        for _ in range(layers):
            jkv, pkv = [], []
            for _ in range(2):
                if int8:
                    v = rng.integers(-127, 128, (rows, page, heads, dim),
                                     dtype=np.int8)
                    s = rng.random((rows, heads), dtype=np.float32)
                    jkv.append(JaxQP(v, s))
                    pkv.append(PortQP(torch.from_numpy(v.copy()),
                                      torch.from_numpy(s.copy())))
                else:
                    x = rng.standard_normal((rows, page, heads, dim),
                                            dtype=np.float32)
                    jkv.append(x)
                    pkv.append(torch.from_numpy(x.copy()))
            jpairs.append(tuple(jkv))
            ppairs.append(tuple(pkv))
        jax_data.append(jpairs)
        port_data.append(ppairs)
    return jax_data, port_data


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_checksums_equal_jax_on_the_same_bytes(int8):
    jax_data, port_data = _host_payload(int8)
    ours = port_engine._swap_record_checksum(3, 17, port_data)
    assert ours == jax_engine._swap_record_checksum(3, 17, jax_data)
    slabs = port_engine._stage_slab_checksums(port_data)
    assert slabs == jax_engine._stage_slab_checksums(jax_data)
    assert len(slabs) == 2 and slabs[0] != slabs[1]
    assert port_engine._swap_record_nbytes(port_data) == \
        jax_engine._swap_record_nbytes(jax_data)
    # the flip lands on stage 0, layer 0, K values, byte 0, in a copy
    k = port_data[0][0][0]
    bad = port_engine._flip_first_byte(k)
    leaf, src = (bad.values, k.values) if int8 else (bad, k)
    assert leaf.data_ptr() != src.data_ptr()
    diff = (leaf.reshape(-1).view(torch.uint8)
            != src.reshape(-1).view(torch.uint8)).nonzero().flatten()
    assert diff.tolist() == [0]


def _payload_cases():
    base = _record(jax_disagg).to_dict()
    geometry = dict(page_size=8, max_pages_per_request=4, stages=2,
                    kv_dtype="float32")
    muts = [
        ("clean", lambda d: None, None),
        ("clean_geometry", lambda d: None, geometry),
        ("not_a_dict", None, None),
        ("request_id", lambda d: d.update(request_id=-3), None),
        ("bool_id", lambda d: d.update(request_id=False), None),
        ("source", lambda d: d.update(source=""), None),
        ("pages_zero", lambda d: d.update(pages=0), None),
        ("watermark", lambda d: d.update(prefilled_len=2), None),
        ("pages_over", lambda d: d.update(pages=5), None),
        ("cover", lambda d: d.update(index=40), None),
        ("checksum", lambda d: d.update(checksum="x"), None),
        ("slabs", lambda d: d.update(slab_checksums=[_HEX]), None),
        ("slabs_type", lambda d: d.update(slab_checksums="ab"), None),
        ("kv_dtype", lambda d: d.update(kv_dtype=None), None),
        ("many", lambda d: d.update(pages=0, source=3, checksum=1), None),
        ("geometry_page", lambda d: None, dict(geometry, page_size=16)),
        ("geometry_dtype", lambda d: None, dict(geometry, kv_dtype="int8")),
        ("geometry_partial", lambda d: None, dict(stages=3)),
        ("geometry_type", lambda d: None, [8]),
    ]
    out = []
    for name, mutate, geo in muts:
        doc = "not a dict" if mutate is None else copy.deepcopy(base)
        if mutate is not None:
            mutate(doc)
        out.append(pytest.param(doc, geo, id=name))
    return out


@pytest.mark.parametrize("doc,geometry", _payload_cases())
def test_verify_handoff_payload_equals_jax(doc, geometry):
    ours = port_plan_check.verify_handoff_payload(doc, geometry)
    assert ours == jax_plan_check.verify_handoff_payload(doc, geometry)


# --------------------------------------------------------------------------
# the engine's handoff plane and swap fault
# --------------------------------------------------------------------------

COUNTERS = ("handoffs_out", "handoffs_in", "handoff_failures",
            "handoff_bytes", "preemptions", "swap_outs", "swap_ins",
            "swap_corruptions", "finished")


def _engine(side, layer_cfgs, **over):
    kw = dict(num_slots=2, max_len=48, buckets=(8, 16), kv_layout="paged",
              page_size=8)
    kw.update(over)
    if side.name == "port":
        kw["devices"] = [torch.device("cpu")]
    return side.serving.ServingEngine(layer_cfgs, side.params, **kw)


def _engine_story(side, layer_cfgs):
    """Export a decoding request from one engine and import it on
    another; refuse a poisoned record; corrupt a parked swap record,
    and one whose resume prefix has outgrown every bucket; import a
    record whose resume prefix fits no bucket, clean and poisoned.
    Returns streams, counters and the exporter's state."""
    flip = port_engine._flip_first_byte if side.name == "port" else _jax_flip
    side.telemetry.enable_tracing()
    try:
        src, dst = _engine(side, layer_cfgs), _engine(side, layer_cfgs)
        victim, bystander = side.requests(17, [(5, 10), (7, 8)])
        src.submit(victim)
        src.submit(bystander)
        while len(victim.tokens) < 2:
            src.step()
        free0 = src.free_slots
        req, rec = src.export_handoff(victim.request_id)
        rid = victim.request_id
        left = dict(
            running=rid in src._running, swapped=rid in src._swapped,
            queued=any(r is req for r in src.queued_requests),
            pages=src._pool.holds(rid), slot=req.slot,
            queue_mark="queued" in req.trace_marks,
            freed=src.free_slots - free0)
        refused = [_outcome(lambda: src.export_handoff(bystander.request_id
                                                       + 99))]
        assert dst.import_handoff(req, rec) is True
        refused.append(_outcome(lambda: dst.import_handoff(req, rec)))
        src.run()
        dst.run()
        # a poisoned record: refused at import, recomputed from prompt
        a, b = _engine(side, layer_cfgs), _engine(side, layer_cfgs)
        (poisoned,) = side.requests(23, [(6, 9)])
        a.submit(poisoned)
        while len(poisoned.tokens) < 3:
            a.step()
        _, prec = a.export_handoff(poisoned.request_id)
        k0, v0 = prec["data"][0][0]
        prec["data"][0][0] = (flip(k0), v0)
        assert b.import_handoff(poisoned, prec) is False
        b.run()
        # a parked swap record corrupted, forced and targeted
        c = _engine(side, layer_cfgs)
        swapped, other = side.requests(31, [(5, 10), (7, 8)])
        c.submit(swapped)
        c.submit(other)
        while len(swapped.tokens) < 2:
            c.step()
        forced = c.corrupt_swap_record(force=True)
        none_left = _outcome(lambda: c.corrupt_swap_record(123456))
        c.run()
        c._pool.check_consistency()
        # a corrupted record that was the only way back: the resume
        # prefix has outgrown every bucket, so the victim FAILS, reasoned
        only = _engine(side, layer_cfgs, max_len=32, buckets=(8,))
        (doomed,) = side.requests(23, [(6, 10)])
        only.submit(doomed)
        while len(doomed.tokens) < 4:
            only.step()
        only.preempt(doomed.request_id, mode="swap")
        only.corrupt_swap_record(doomed.request_id)
        only.run()
        only._pool.check_consistency()
        # resume prefixes past every bucket of the importing engine
        d = _engine(side, layer_cfgs, max_len=32)
        tight = [_engine(side, layer_cfgs, max_len=32, buckets=(8,))
                 for _ in range(2)]
        long_a, long_b = side.requests(41, [(6, 10), (6, 10)])
        for r in (long_a, long_b):
            d.submit(r)
        while len(long_a.tokens) < 4 or len(long_b.tokens) < 4:
            d.step()
        ra, reca = d.export_handoff(long_a.request_id)
        rb, recb = d.export_handoff(long_b.request_id)
        k0, v0 = recb["data"][0][0]
        recb["data"][0][0] = (flip(k0), v0)
        verdicts = [tight[0].import_handoff(ra, reca),
                    tight[1].import_handoff(rb, recb)]
        tight[0].run()
        fates = [(r.status, r.fail_reason) for r in (long_a, long_b,
                                                      doomed)]
    finally:
        side.telemetry.disable_tracing()
    stats = [{k: getattr(e.stats, k) for k in COUNTERS}
             for e in (src, dst, a, b, c, only, d, *tight)]
    outs = [r.output().tolist() for r in (victim, bystander, poisoned,
                                          swapped, other, long_a)]
    return dict(left=left, refused=refused, stats=stats, streams=outs,
                forced=forced == swapped.request_id, none_left=none_left,
                verdicts=verdicts, fates=fates,
                requests=[victim, bystander, poisoned, swapped, other,
                          long_a])


def _jax_flip(leaf):
    """tests/test_chaos.py's flip, on a JAX engine's host record."""
    values = leaf.values if isinstance(leaf, JaxQP) else leaf
    raw = bytearray(np.ascontiguousarray(values).tobytes())
    raw[0] ^= 0xFF
    bad = np.frombuffer(bytes(raw), values.dtype).reshape(values.shape)
    return JaxQP(bad, leaf.scale) if isinstance(leaf, JaxQP) else bad


def test_engine_handoff_and_swap_fault_equal_jax(gpt):
    layer_cfgs, _, sds = gpt
    jax_side, port_side = sides(gpt)
    ours = _engine_story(port_side, layer_cfgs)
    theirs = _engine_story(jax_side, layer_cfgs)
    for key in ("left", "stats", "streams", "forced", "verdicts", "fates"):
        assert ours[key] == theirs[key], key
    assert [o[0] for o in ours["refused"]] == \
        [o[0] for o in theirs["refused"]] == ["KeyError", "ValueError"]
    assert ours["none_left"][0] == theirs["none_left"][0] == "KeyError"
    # nothing of the exported request stays on its engine
    assert ours["left"] == dict(running=False, swapped=False, queued=False,
                                pages=False, slot=None, queue_mark=False,
                                freed=1)
    src, dst, a, b, c = ours["stats"][:5]
    assert (src["handoffs_out"], dst["handoffs_in"], b["handoff_failures"],
            c["swap_corruptions"]) == (1, 1, 1, 1)
    assert src["handoff_bytes"] > 0 and dst["handoff_bytes"] == 0
    assert ours["verdicts"] == [True, False]
    assert ours["fates"] == [
        ("finished", None),
        ("failed", "handoff record corrupted and the resume prefix fits "
                   "no bucket"),
        ("failed", "swap record corrupted and the resume prefix fits no "
                   "bucket")]
    assert ours["stats"][5]["swap_corruptions"] == 1
    reqs = ours["requests"]
    port_generate_identity(layer_cfgs, sds, reqs,
                           {r.request_id: r.output() for r in reqs})


# --------------------------------------------------------------------------
# DisaggFleet against JAX's (tests/test_disagg.py's scenarios)
# --------------------------------------------------------------------------


def _paged(**over):
    kw = dict(num_slots=2, max_len=48, buckets=(8, 16, 32),
              kv_layout="paged", page_size=8, max_concurrency=6)
    kw.update(over)
    return kw


def _make(side, layer_cfgs, prefill=1, decode=1, chips=None, **kw):
    return DISAGG[side.name].DisaggFleet(
        layer_cfgs, side.params, prefill_replicas=prefill,
        decode_replicas=decode, engine_kwargs=_paged(),
        supervisor=side.supervisor(), router=depth_router(side),
        devices=side.devices(chips or prefill + decode), **kw)


def _handoff_counters(fleet):
    return {k: sum(getattr(r.engine.stats, k) for r in fleet.replicas
                   if r.engine is not None)
            for k in ("handoffs_out", "handoffs_in", "handoff_failures",
                      "handoff_bytes")}


def _fleet_view(fleet, requests):
    return dict(
        streams=[r.output().tolist() for r in requests],
        status=[(r.status, r.fail_reason) for r in requests],
        ledger_events=fleet.ledger.events,
        ledger_audit=fleet.ledger.audit(),
        ledger_snapshot=fleet.ledger.snapshot(),
        stats=fleet.stats.snapshot(),
        handoffs=_handoff_counters(fleet),
        roles=[(r.name, r.role, r.state, r.generation)
               for r in fleet.replicas])


def _both(gpt, story):
    """``story(side, layer_cfgs) -> (fleet, requests, extra)`` through
    both packages; the views equal, the port's streams its one-shot
    ``generate``'s."""
    layer_cfgs, _, sds = gpt
    views = []
    for side in sides(gpt):
        fleet, reqs, extra = story(side, layer_cfgs)
        views.append((_fleet_view(fleet, reqs), extra))
        if side.name == "port":
            done = [r for r in reqs if r.status == "finished"]
            port_generate_identity(layer_cfgs, sds, done,
                                   {r.request_id: r.output() for r in done})
    (theirs, jx), (ours, px) = views
    for key in ours:
        assert ours[key] == theirs[key], key
    assert px == jx
    return ours, px


def _until_in_flight(fleet):
    for _ in range(64):
        fleet.step()
        if fleet.ledger.pending():
            return True
    return False


def test_disagg_equals_monolith_and_jax(gpt):
    specs = [(5, 9), (3, 4), (12, 7), (7, 5), (16, 6), (2, 8), (9, 6)]

    def story(side, layer_cfgs):
        mono = side.fleet.ServingFleet(
            layer_cfgs, side.params, replicas=2, engine_kwargs=_paged(),
            supervisor=side.supervisor(), router=depth_router(side),
            devices=side.devices(2))
        mono_reqs = side.requests(11, specs)
        mono_out = mono.run(mono_reqs)
        fleet = _make(side, layer_cfgs)
        reqs = side.requests(11, specs)
        fleet.run(reqs)
        return fleet, reqs, dict(mono=streams(mono_reqs, mono_out),
                                 mono_stats=mono.stats.snapshot())

    ours, extra = _both(gpt, story)
    assert extra["mono"] == ours["streams"]
    audit = ours["ledger_audit"]
    assert audit["conservation_ok"] and audit["pending"] == 0
    assert audit["delivered_total"] == 7 and audit["failed_total"] == 0
    assert ours["handoffs"]["handoffs_out"] == 7 == \
        ours["handoffs"]["handoffs_in"]
    assert ours["handoffs"]["handoff_bytes"] > 0


def test_checksum_refusal_recomputes_like_jax(gpt):
    def story(side, layer_cfgs):
        fleet = _make(side, layer_cfgs)
        reqs = side.requests(3, [(6, 7), (10, 5), (4, 8)])
        for r in reqs:
            assert fleet.submit(r).admitted
        assert _until_in_flight(fleet)
        rid = fleet.corrupt_handoff()
        slot = [r.request_id for r in reqs].index(rid)
        fleet.run()
        decode = fleet.pool_replicas(DISAGG[side.name].DECODE)[0].engine
        return fleet, reqs, dict(slot=slot,
                                 failures=decode.stats.handoff_failures)

    ours, extra = _both(gpt, story)
    assert extra["failures"] == 1
    assert ours["ledger_audit"]["failed_reasons"] == {
        "checksum mismatch at import; recomputing from prompt": 1}
    assert ours["stats"]["failed"] == 0


def test_dead_prefill_replica_redispatches_like_jax(gpt):
    def story(side, layer_cfgs):
        mod = DISAGG[side.name]
        fleet = _make(side, layer_cfgs, decode=2)
        reqs = side.requests(9, [(5, 8), (11, 6), (3, 9), (8, 5), (14, 7),
                                 (6, 6)])
        for r in reqs:
            assert fleet.submit(r).admitted
        assert _until_in_flight(fleet)
        in_flight = [r.request_id for r in fleet.ledger.pending()]
        fleet.pool_replicas(mod.PREFILL)[0].crash()
        fleet.run()
        ids = [r.request_id for r in reqs]
        return fleet, reqs, dict(in_flight=[ids.index(i) for i in in_flight])

    ours, extra = _both(gpt, story)
    assert extra["in_flight"]
    assert ours["ledger_audit"]["pending"] == 0
    assert ours["stats"]["reforms"] >= 1 and ours["stats"]["failed"] == 0


def test_per_pool_admission_equals_jax(gpt):
    def story(side, layer_cfgs):
        mod = DISAGG[side.name]
        ctrl = side.fleet.AdmissionController
        fleet = _make(side, layer_cfgs,
                      decode_admission=ctrl(max_pending=1))
        first = side.requests(17, [(6, 10)] * 4)
        for r in first:
            assert fleet.submit(r).admitted
        assert _until_in_flight(fleet)
        late = side.requests(18, [(6, 6)] * 2)
        decisions = [fleet.submit(r) for r in late]
        tight = _make(side, layer_cfgs,
                      prefill_admission=ctrl(max_pending=1))
        more = side.requests(19, [(6, 6)] * 10)
        tight_decisions = [tight.submit(r) for r in more]
        fleet.run()
        tight.run()
        pools = [(d.admitted, d.reason, (d.detail or {}).get("pool"),
                  bool(d.admitted or d.retry_after_s > 0))
                 for d in decisions + tight_decisions]
        return fleet, first + late, dict(
            pools=pools, tight=_fleet_view(tight, more),
            names=(mod.PREFILL, mod.DECODE))

    ours, extra = _both(gpt, story)
    rejected = [p for p in extra["pools"] if not p[0]]
    assert {p[2] for p in rejected} == {"decode", "prefill"}
    assert all(p[1] and p[3] for p in rejected)


class StubSlo:
    """tests/test_disagg.py's duck-typed burn source."""

    def __init__(self):
        self.firing = ()
        self.firing_streak = 0
        self.quiet_streak = 0

    def burn(self, target="ttft_p95"):
        self.firing = (target,)
        self.firing_streak += 1
        self.quiet_streak = 0

    def clear(self):
        self.firing = ()
        self.firing_streak = 0

    def evaluate(self, tracer=None):
        return []


def test_per_role_autoscaler_equals_jax(gpt):
    def story(side, layer_cfgs):
        mod = DISAGG[side.name]
        auto = side.fleet.FleetAutoscaler(
            min_replicas=2, max_replicas=4, up_streak=2, down_streak=4,
            cooldown_ticks=3, chip_budget=8,
            pools={mod.PREFILL: dict(min_replicas=1, max_replicas=2),
                   mod.DECODE: dict(min_replicas=1, max_replicas=2)})
        fleet = _make(side, layer_cfgs, chips=4, autoscaler=auto)
        fleet.slo = StubSlo()
        served = side.requests(21, [(6, 5), (10, 4), (4, 6), (8, 5)])
        for r in served[:2]:
            assert fleet.submit(r).admitted
        for _ in range(3):
            fleet.slo.burn("ttft_p95")
            fleet.step()
        grown = len(fleet.pool_replicas(mod.PREFILL))
        for r in served[2:]:
            assert fleet.submit(r).admitted
        fleet.slo.clear()
        while fleet.has_work():
            fleet.step()
        for _ in range(40):
            fleet.step()
            if fleet.stats.scale_downs >= 1:
                break
        events = [(e["kind"], e.get("pool"), e["tick"]) for e in auto.events]
        return fleet, served, dict(grown=grown, events=events)

    ours, extra = _both(gpt, story)
    assert extra["grown"] == 2
    assert [(k, p) for k, p, _ in extra["events"]] == [
        ("scale_up", "prefill"), ("scale_down", "prefill")]
    assert ours["stats"]["scale_ups"] == ours["stats"]["scale_downs"] == 1


# --------------------------------------------------------------------------
# the command
# --------------------------------------------------------------------------


def test_command_on_the_cpu_and_no_card(tmp_path, monkeypatch, capsys):
    """``bench_disagg`` at ``--device cpu``, one measured replay of each
    topology (no throwaway replays): its exit code is its gates', its
    JSON the reference bench's schema, every mechanics gate held (the
    latency gates read this host's clock); without ``--device`` a box
    with no card raises."""
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    real = bench_disagg.run_bench
    monkeypatch.setattr(bench_disagg, "run_bench", lambda **kw: real(
        **dict(kw, replays=1, throwaway=False)))
    out = tmp_path / "disagg.json"
    rc = bench_disagg.main(["--device", "cpu", "--rate-scale", "1.0",
                            "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["passed"] else 1)
    assert {"bench", "device_kind", "model", "fleet", "scenario",
            "rate_scale", "epilogue_ticks", "replays_per_topology", "digest",
            "notes", "runs", "gates", "passed"} <= set(report)
    assert report["bench"] == "disagg_vs_monolithic"
    gates = report["gates"]
    assert set(gates) == {
        "ttft_p95_improved", "tpot_p95_improved", "zero_lost_tokens",
        "token_identical", "zero_steady_state_recompiles",
        "every_request_handed_off", "ledger_conserved",
        "workload_replayable", "replay_deterministic"}
    assert all(v for k, v in gates.items() if not k.endswith("improved"))
    disagg = report["runs"]["disagg"]
    assert disagg["handoff_counters"]["handoffs_out"] == \
        disagg["ledger"]["delivered_total"] > 0
    assert disagg["replays"][0]["export_s_per_record"] > 0
    assert "# PASS" in capsys.readouterr().out or not report["passed"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_disagg.main([])
