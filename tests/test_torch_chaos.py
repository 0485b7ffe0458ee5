"""The port's chaos plane (``chaos/plan.py``, ``injector.py``,
``invariants.py``, ``plan_check.verify_fault_plan``) against the JAX
package's.

Exact: every catalog plan at seeds 0, 1 and 7 (``digest()``,
``resolved_events()``, ``to_dict()``); ``FAULT_KINDS`` and
``FLEET_TARGET_KINDS`` across the port's plan, the port's plan-check
twin and JAX's; every malformed event or plan of ``tests/test_chaos.py``
refused with JAX's message, and ``verify_fault_plan``'s problem lists;
the plan module loaded by file path with torch and numpy blocked; the
injector on the port's fleet (the chaos bench's tiny GPT, JAX's weights,
the CPU) giving
JAX's event log, recoveries and counters; the flight recorder filing a
chaos crash's incident with JAX's cause chain; and four catalog
campaigns (``reform_flap``, ``mid_drain_kill``, ``swap_corruption``,
``prefill_kill_mid_handoff``) through the port's
``bench_chaos`` harness against the same harness over the JAX package:
the deterministic event log, the audit's verdicts and digest, the
fleet counters and every stream equal.  Host timing stays out of the
compared decisions (depth-only routing, sickness parked) as
``tests/torch_fleet_helpers.py`` says."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from skycomputing_tpu import chaos as jax_chaos
from skycomputing_tpu import disagg as jax_disagg
from skycomputing_tpu import workload as jax_workload
from skycomputing_tpu.analysis import plan_check as jax_plan_check
from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.chaos import plan as jax_plan
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.telemetry import incidents as jax_incidents
from skycomputing_tpu.telemetry.slo import SloMonitor, SloTarget
from skycomputing_tpu_torch import chaos as port_chaos
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch import workload as port_workload
from skycomputing_tpu_torch.analysis import plan_check as port_plan_check
from skycomputing_tpu_torch.bench_serving import _one_shot
from skycomputing_tpu_torch.chaos import plan as port_plan
from skycomputing_tpu_torch.telemetry import incidents as port_incidents
from skycomputing_tpu_torch.tools import bench_chaos
from torch_fleet_helpers import (
    depth_router,
    port_generate_identity,
    sides,
    stdlib_load,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

CHAOS = {"jax": jax_chaos, "port": port_chaos}
WORKLOAD = {"jax": jax_workload, "port": port_workload}
PARKED = dict(bench_chaos.SUPERVISOR, sick_threshold=float("inf"))


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 - the comparison is the point
        return type(exc).__name__, str(exc)


# --------------------------------------------------------------------------
# the plan core (pure stdlib)
# --------------------------------------------------------------------------


def _plan_view(mod, name, seed):
    p = mod.get_fault_plan(name, seed=seed)
    return dict(digest=p.digest(), doc=p.to_dict(),
                events=[e.key() for e in p.resolved_events()],
                last=p.last_declared_tick, scenario=p.scenario)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", jax_plan.fault_plan_names())
def test_catalog_plan_equals_jax(name, seed):
    assert _plan_view(port_plan, name, seed) == \
        _plan_view(jax_plan, name, seed)


def test_catalog_names_kinds_and_exports_equal_jax():
    assert port_plan.fault_plan_names() == jax_plan.fault_plan_names()
    assert tuple(port_plan.FAULT_KINDS) == \
        tuple(port_plan_check.FAULT_KINDS) == \
        tuple(jax_plan.FAULT_KINDS) == tuple(jax_plan_check.FAULT_KINDS)
    assert tuple(port_plan_check.FLEET_TARGET_KINDS) == \
        tuple(jax_plan_check.FLEET_TARGET_KINDS)
    assert set(port_chaos.__all__) == set(jax_chaos.__all__)
    assert _outcome(lambda: port_plan.get_fault_plan("meteor_strike")) == \
        _outcome(lambda: jax_plan.get_fault_plan("meteor_strike"))


def _crash_plan(m, events, **kw):
    base = dict(name="t", seed=0, scenario="tenant_mix",
                recovery_budget_ticks=30)
    base.update(kw)
    return m.FaultPlan(events=tuple(events), **base)


BAD = {
    "tick": lambda m: m.FaultEvent(tick=-1, kind=m.REPLICA_CRASH),
    "duration": lambda m: m.FaultEvent(tick=0, kind=m.REPLICA_CRASH,
                                       duration=0),
    "jitter": lambda m: m.FaultEvent(tick=0, kind=m.REPLICA_CRASH,
                                     jitter_ticks=-1),
    "kind": lambda m: m.FaultEvent(tick=0, kind="meteor_strike"),
    "crash_fleet": lambda m: m.FaultEvent(tick=0, kind=m.REPLICA_CRASH,
                                          target="fleet"),
    "blip_index": lambda m: m.FaultEvent(tick=0, kind=m.ADMISSION_BLIP,
                                         target="index:0"),
    "index_x": lambda m: m.FaultEvent(tick=0, kind=m.REPLICA_CRASH,
                                      target="index:x"),
    "rack": lambda m: m.FaultEvent(tick=0, kind=m.REPLICA_CRASH,
                                   target="rack:3"),
    "slowdown_params": lambda m: m.FaultEvent(tick=0,
                                              kind=m.STAGE_SLOWDOWN),
    "builds": lambda m: m.FaultEvent(tick=0, kind=m.REFORM_FAILURE,
                                     params=(("builds", 0),)),
    "crash_params": lambda m: m.FaultEvent(tick=0, kind=m.REPLICA_CRASH,
                                           params=(("seconds", 1),)),
    "force": lambda m: m.FaultEvent(tick=0, kind=m.SWAP_CORRUPTION,
                                    params=(("force", "yes"),)),
    "plan_empty": lambda m: _crash_plan(m, [], name="empty"),
    "plan_name": lambda m: _crash_plan(
        m, [m.FaultEvent(tick=0, kind=m.REPLICA_CRASH)], name=""),
    "plan_scenario": lambda m: _crash_plan(
        m, [m.FaultEvent(tick=0, kind=m.REPLICA_CRASH)], scenario=""),
    "plan_budget": lambda m: _crash_plan(
        m, [m.FaultEvent(tick=0, kind=m.REPLICA_CRASH)],
        recovery_budget_ticks=0),
    "plan_replicas": lambda m: _crash_plan(
        m, [m.FaultEvent(tick=0, kind=m.REPLICA_CRASH)], replicas=0),
    "plan_rate": lambda m: _crash_plan(
        m, [m.FaultEvent(tick=0, kind=m.REPLICA_CRASH)], rate_scale=0.0),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_refusals_equal_jax(case):
    ours = _outcome(lambda: BAD[case](port_plan))
    assert ours[0] == "ValueError"
    assert ours == _outcome(lambda: BAD[case](jax_plan))


def test_jitter_lowering_equals_jax():
    def view(m):
        plan = _crash_plan(m, [
            m.FaultEvent(tick=10, kind=m.REPLICA_CRASH, jitter_ticks=3),
            m.FaultEvent(tick=20, kind=m.REPLICA_CRASH, target="index:1"),
            m.FaultEvent(tick=1, kind=m.REPLICA_CRASH, jitter_ticks=4),
        ], seed=11)
        return [[e.key() for e in plan.with_seed(s).resolved_events()]
                for s in range(8)], plan.digest()

    assert view(port_plan) == view(jax_plan)


FAULT_PLAN_MUTATIONS = {
    "clean": lambda d: None,
    "kind": lambda d: d["events"][0].update(kind="meteor"),
    "tick": lambda d: d["events"][0].update(tick=-2),
    "target": lambda d: d["events"][0].update(target=""),
    "builds": lambda d: d["events"][0]["params"].pop("builds"),
    "events": lambda d: d.update(events=[]),
    "seed": lambda d: d.update(seed="zero"),
    "rate": lambda d: d.update(rate_scale=0),
    "budget": lambda d: d.update(recovery_budget_ticks=0),
    "blip_index": lambda d: d["events"].__setitem__(0, dict(
        tick=1, kind="admission_blip", target="index:0", params={},
        duration=2, jitter_ticks=0)),
    "crash_fleet": lambda d: d["events"][1].update(target="fleet"),
    "handoff_index": lambda d: d["events"][1].update(
        kind="handoff_corruption"),
    "slowdown": lambda d: d["events"][1].update(kind="stage_slowdown",
                                                params={"seconds": 0}),
    "params_type": lambda d: d["events"][1].update(params=[1]),
    "duration": lambda d: d["events"][1].update(duration=0),
    "jitter": lambda d: d["events"][1].update(jitter_ticks=True),
    "event_type": lambda d: d["events"].append("boom"),
    "not_a_dict": None,
}


@pytest.mark.parametrize("case", sorted(FAULT_PLAN_MUTATIONS))
def test_verify_fault_plan_equals_jax(case):
    mutate = FAULT_PLAN_MUTATIONS[case]
    if mutate is None:
        doc = "not a dict"
    else:
        doc = copy.deepcopy(jax_plan.get_fault_plan("reform_flap").to_dict())
        mutate(doc)
    ours = port_plan_check.verify_fault_plan(doc)
    assert ours == jax_plan_check.verify_fault_plan(doc)
    assert bool(ours) == (case != "clean")


def test_plan_module_is_stdlib_only():
    got = stdlib_load(Path(port_plan.__file__),
                      "[mod.get_fault_plan(n, seed=7).digest() "
                      "for n in mod.fault_plan_names()]")
    assert got == [jax_plan.get_fault_plan(n, seed=7).digest()
                   for n in jax_plan.fault_plan_names()]


# --------------------------------------------------------------------------
# the injector and the flight recorder on tiny GPT's fleets
# --------------------------------------------------------------------------


def _fleet(side, layer_cfgs, replicas=2, **engine_kw):
    base = dict(num_slots=3, max_len=64, buckets=(8, 16))
    base.update(engine_kw)
    return side.fleet.ServingFleet(
        layer_cfgs, side.params, replicas=replicas, engine_kwargs=base,
        supervisor=side.supervisor(), router=depth_router(side),
        devices=side.devices(replicas))


def test_injector_log_and_recoveries_equal_jax(gpt):
    """tests/test_chaos.py's exact-tick plan (a crash, a skip, a blip, a
    3 ms stall that a parked supervisor does not judge) on both
    packages' fleets."""
    layer_cfgs, _, sds = gpt
    out = []
    for side in sides(gpt):
        m = CHAOS[side.name]
        plan = _crash_plan(m.plan, [
            m.FaultEvent(tick=2, kind=m.REPLICA_CRASH, target="index:0"),
            m.FaultEvent(tick=3, kind=m.REPLICA_CRASH, target="index:9"),
            m.FaultEvent(tick=4, kind=m.ADMISSION_BLIP, target="fleet",
                         duration=2),
            m.FaultEvent(tick=6, kind=m.STAGE_SLOWDOWN, target="index:1",
                         params=(("seconds", 0.003),), duration=1),
        ])
        fleet = _fleet(side, layer_cfgs)
        fleet.fault_injector = m.FaultInjector(plan)
        reqs = side.requests(4, [(5, 12), (3, 10)])
        for r in reqs:
            fleet.submit(r)
        for _ in range(8):
            fleet.step()
        blip = fleet.admission.blip_active
        fleet.run()
        for _ in range(6):
            fleet.step()
        inj = fleet.fault_injector
        out.append(dict(
            log=inj.event_log(), det=inj.deterministic_log(),
            recoveries=inj.recoveries, blip=blip,
            settled=m.fleet_settled(fleet), stats=fleet.stats.snapshot(),
            streams=[r.output().tolist() for r in reqs]))
        if side.name == "port":
            port_generate_identity(layer_cfgs, sds, reqs,
                                   {r.request_id: r.output() for r in reqs})
    theirs, ours = out
    assert ours == theirs
    assert [(e["tick"], e["ok"]) for e in ours["log"]] == [
        (2, True), (3, False), (4, True), (6, True)]
    assert ours["log"][1]["note"] == "index 9 out of range"
    assert ours["stats"]["faults_injected"] == 3
    assert ours["recoveries"] and ours["settled"] and not ours["blip"]


def test_injector_refuses_unverified_plan_like_jax(gpt):
    class DriftedPlan:
        name = "drifted"
        recovery_budget_ticks = 10

        def resolved_events(self):
            return []

        def to_dict(self):
            return {"name": "drifted"}

    out = []
    for side in sides(gpt):
        fleet = _fleet(side, gpt[0], replicas=1)
        fleet.fault_injector = CHAOS[side.name].FaultInjector(DriftedPlan())
        out.append((_outcome(fleet.step), fleet.stats.faults_injected))
    assert out[0] == out[1]
    assert out[1][0][0] == "ValueError" and out[1][1] == 0


def test_flight_incident_cause_chain_equals_jax(gpt):
    """tests/test_flight.py's end-to-end incident: a chaos crash of
    replica 0 at tick 3 with the flight recorder attached."""
    views = []
    for side, incidents in zip(sides(gpt), (jax_incidents, port_incidents)):
        m = CHAOS[side.name]
        fleet = side.fleet.ServingFleet(
            gpt[0], side.params, replicas=2,
            engine_kwargs=dict(num_slots=2, max_len=48, buckets=(16, 32)),
            supervisor=side.supervisor(), router=depth_router(side),
            devices=side.devices(2))
        fleet.attach_flight(quiet_ticks=6)
        fleet.fault_injector = m.FaultInjector(m.FaultPlan(
            name="flight_e2e", seed=0, scenario="tenant_mix",
            recovery_budget_ticks=12,
            events=(m.FaultEvent(tick=3, kind=m.REPLICA_CRASH,
                                 target="index:0"),)))
        for r in side.requests(0, [(6, 4)] * 3):
            fleet.submit(r)
        for _ in range(20):
            fleet.step()
        views.append(dict(
            bundles=[incidents.deterministic_bundle_view(b)
                     for b in fleet.bundles],
            digests=[b["digest"] for b in fleet.bundles],
            chains=[incidents.chain_stages(incidents.cause_chain(
                b["flight_log"])) for b in fleet.bundles],
            log=fleet.flight.deterministic_log(),
            opened=fleet.stats.incidents_opened))
    assert views[1] == views[0]
    assert views[1]["chains"][0][0] == "fault"
    assert "impact" in views[1]["chains"][0]


# --------------------------------------------------------------------------
# catalog campaigns through bench_chaos's harness, both packages
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt():
    """The chaos bench's model (tiny GPT, 160 positions) in both
    packages, JAX's weights converted."""
    cfg = GptConfig(**bench_chaos.MODEL)
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(0),
                                        np.ones((1, 8), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs)


def _jax_harness(side, layer_cfgs, name):
    """``tools/bench_chaos.py``'s replays over the JAX package, with the
    port harness's depth-only router and parked supervisor."""
    plan = jax_plan.get_fault_plan(name, seed=0)
    engine = dict(bench_chaos.ENGINE)

    def make_fleet():
        auto = None
        if plan.autoscale:
            auto = side.fleet.FleetAutoscaler(
                min_replicas=1, max_replicas=max(3, plan.replicas),
                up_streak=3, down_streak=6, cooldown_ticks=8,
                slack_utilization=0.35)
        kw = dict(supervisor=side.fleet.FleetSupervisor(**PARKED),
                  autoscaler=auto, router=depth_router(side),
                  devices=side.devices(max(3, plan.replicas)))
        if plan.disagg:
            fleet = jax_disagg.DisaggFleet(
                layer_cfgs, side.params, prefill_replicas=1,
                decode_replicas=plan.replicas - 1,
                engine_kwargs=dict(engine), **kw)
        else:
            fleet = side.fleet.ServingFleet(
                layer_cfgs, side.params, replicas=plan.replicas,
                engine_kwargs=dict(engine), **kw)
        if auto is not None:
            fleet.attach_slo(SloMonitor([SloTarget(
                name="queue_pressure", metric="fleet.queue_depth",
                threshold=2, budget=0.25, fast_window=1, slow_window=8)]))
        return fleet

    def replay(injector):
        fleet = make_fleet()
        if injector is not None:
            fleet.fault_injector = injector
        probe = jax_chaos.make_probe(fleet)
        scenario = jax_workload.get_scenario(
            plan.scenario, seed=plan.scenario_seed,
            rate_scale=plan.rate_scale, ticks_scale=plan.ticks_scale)
        report = jax_workload.ScenarioPlayer(scenario, fleet,
                                             sample_fn=probe).play()
        for _ in range(plan.recovery_budget_ticks + 10):
            fleet.step()
            report.timeline.append(probe())
        return fleet, report

    ref = replay(None)
    inj = jax_chaos.FaultInjector(plan)
    fleet, report = replay(inj)
    audit = jax_chaos.audit_run(fleet, report, reference=ref[1],
                                injector=inj)
    return ref, (fleet, report, inj, audit)


def _campaign_view(ref, faulted):
    (ref_fleet, ref_report), (fleet, report, inj, audit) = ref, faulted
    return dict(
        log=inj.deterministic_log(), recoveries=inj.recoveries,
        audit=audit.to_dict(), audit_digest=audit.digest(),
        stats=fleet.stats.snapshot(), ref_stats=ref_fleet.stats.snapshot(),
        digest=report.digest,
        verdicts=[(v.admitted, v.reason, v.request.status,
                   v.request.fail_reason) for v in report.verdicts],
        streams=[v.request.output().tolist() for v in report.verdicts],
        ref_streams=[v.request.output().tolist()
                     for v in ref_report.verdicts],
        ledger=_ledger_by_arrival(fleet, report))


def _ledger_by_arrival(fleet, report):
    """The handoff ledger's events with request ids replaced by arrival
    positions (ids come from a process-wide counter)."""
    if not hasattr(fleet, "ledger"):
        return None
    pos = {v.request.request_id: i for i, v in enumerate(report.verdicts)}
    return [dict(e, request_id=pos[e["request_id"]])
            for e in fleet.ledger.events]


@pytest.mark.parametrize("name", ["reform_flap", "mid_drain_kill",
                                  "swap_corruption",
                                  "prefill_kill_mid_handoff"])
def test_campaign_equals_jax(gpt, name):
    layer_cfgs, _, sds = gpt
    jax_side, port_side = sides(gpt)
    theirs = _campaign_view(*_jax_harness(jax_side, layer_cfgs, name))
    report, runs = bench_chaos.run_bench(
        [name], device="cpu", params=sds, supervisor_kwargs=PARKED,
        router_factory=lambda: depth_router(port_side))
    run = runs[name]
    ours = _campaign_view(run["reference"], run["faulted"])
    for key in ours:
        assert ours[key] == theirs[key], key
    gates = report["plans"][name]["gates"]
    assert all(gates.values()), gates
    assert report["passed"]
    # the determinism run told the same story
    again = run["again"]
    assert again[2].deterministic_log() == ours["log"]
    assert again[3].digest() == ours["audit_digest"]
    if name == "swap_corruption":
        assert ours["stats"]["faults_injected"] >= 1
        assert sum(r.engine.stats.swap_corruptions
                   for r in run["faulted"][0].replicas) >= 1
    if name == "prefill_kill_mid_handoff":
        failed = run["faulted"][0].ledger.audit()["failed_reasons"]
        assert failed.get(
            "checksum mismatch at import; recomputing from prompt", 0) >= 1
    one_shot = _one_shot(layer_cfgs, sds, "cpu",
                         bench_chaos.MODEL["max_position_embeddings"])
    for v in run["faulted"][1].finished:
        np.testing.assert_array_equal(v.request.output(),
                                      one_shot(v.request))


def test_command_list_and_no_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    assert bench_chaos.main(["--list"]) == 0
    listing = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listing] == \
        jax_plan.fault_plan_names()
    out = tmp_path / "chaos.json"
    rc = bench_chaos.main(["--device", "cpu", "--plan", "swap_corruption",
                           "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["passed"] else 1) == 0
    assert {"bench", "device_kind", "model", "fleet", "seed", "notes",
            "plans", "passed"} <= set(report)
    plan = report["plans"]["swap_corruption"]
    assert {"plan", "plan_digest", "trace_digest", "summary",
            "reference_summary", "event_log", "recoveries", "audit",
            "audit_digest", "fleet_stats", "quarantined", "gates",
            "passed", "wall_s"} <= set(plan)
    assert plan["plan_digest"] == \
        jax_plan.get_fault_plan("swap_corruption").digest()
    with pytest.raises(SystemExit):
        bench_chaos.main(["--device", "cpu", "--plan", "meteor"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_chaos.main(["--plan", "swap_corruption"])
