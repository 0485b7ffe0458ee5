"""The port's flight recorder, incident plane and SLO monitor against the
JAX package's: each detector rule's fire and non-fire paths give JAX's
verdicts on the same event streams; ring bounds and eviction; the
incident engine's lifecycle; postmortem bundles, ``cause_chain`` /
``chain_stages`` and ``bundle_digest`` equal JAX's, for hand-made
stories and for the same fleet replay; the SLO monitor's burn rates and
alerts equal JAX's on the same series; and the readers of the bundles
(``skyreport`` and ``trace_report --incidents``) equal JAX's tools on
the same bundle and trace.

One field differs between the packages' fleet bundles by design: the
JAX fleet's flight log carries a ``serving/recompile`` event where an
XLA compile happened inside a tick, and the port runs eagerly and never
compiles.  The fleet replay warms every bucket first, so JAX's log has
no such event in it, and the test asserts that before it holds the
digests equal."""

import json
from pathlib import Path

import pytest
import torch

from skycomputing_tpu import telemetry as jax_telemetry
from skycomputing_tpu.telemetry import incidents as jax_incidents
from skycomputing_tpu.telemetry import slo as jax_slo
from skycomputing_tpu_torch import telemetry
from skycomputing_tpu_torch.telemetry import incidents, slo
from skycomputing_tpu_torch.tools import skyreport
from skycomputing_tpu_torch.tools import trace_report
from torch_fleet_helpers import replay, sides, tiny_gpt
from tools._loader import load_by_path

pytestmark = pytest.mark.torch_port

BOTH = [(telemetry, incidents), (jax_telemetry, jax_incidents)]


class FakeTS:
    """Duck-typed ``MetricsTimeseries``: just enough for the rules."""

    def __init__(self, series, types=None):
        self._series = {k: list(v) for k, v in series.items()}
        self._types = dict(types or {})

    def keys(self):
        return sorted(self._series)

    def key_count(self):
        return len(self._series)

    def type_of(self, key):
        return self._types.get(key, "gauge")

    def latest(self, key):
        vals = self._series.get(key)
        return vals[-1] if vals else None

    def values(self, key, window=None):
        vals = self._series.get(key, [])
        return vals[-int(window):] if window is not None else list(vals)


def _ev(tel, tick, lane, kind, subject="", **detail):
    return tel.FlightEvent(tick=tick, lane=lane, kind=kind,
                           subject=subject, detail=detail)


# each rule: (constructor kwargs, [(tick, events, series, types), ...]):
# the calls walk its non-fire and fire paths in order
RULES = {
    "SteadyStateRecompileRule": (dict(warmup_ticks=10), [
        (5, [(5, "serving", "recompile", "replica0", dict(count=1))],
         None, None),
        (20, [], None, None),
        (20, [(20, "serving", "recompile", "replica0", dict(count=1))],
         None, None)]),
    "CounterRegressionRule": (dict(), [
        (0, [], {"fleet.dispatched": [5.0, 7.0],
                 "fleet.queue_depth": [9.0, 1.0]},
         {"fleet.dispatched": "counter"}),
        (4, [], {"fleet.dispatched": [5.0, 7.0, 3.0],
                 "fleet.queue_depth": [9.0, 1.0]},
         {"fleet.dispatched": "counter"})]),
    "QueueDepthSpikeRule": (dict(factor=4.0, min_depth=24.0,
                                 baseline_window=32), [
        (10, [], {"fleet.queue_depth": [2.0, 3.0, 2.0, 2.0, 30.0]}, None),
        (10, [], {"fleet.queue_depth": [2.0, 3.0, 2.0, 2.0, 11.0]}, None),
        (10, [], {"fleet.queue_depth": [20.0, 25.0, 22.0, 21.0, 26.0]},
         None),
        (10, [], {}, None)]),
    "QuarantineRule": (dict(), [
        (5, [], None, None),
        (5, [(5, "supervisor", "reform_failed", "replica1",
              dict(retired=False))], None, None),
        (6, [(6, "supervisor", "replica_retired", "replica1", {})],
         None, None)]),
    "HandoffFailureStreakRule": (dict(threshold=2, window_ticks=40), [
        (10, [(10, "disagg", "handoff_failed", "", dict(reason="c"))],
         None, None),
        (60, [(60, "disagg", "handoff_failed", "", dict(reason="c"))],
         None, None),
        (70, [(70, "disagg", "handoff_failed", "", dict(reason="c"))],
         None, None)]),
    "SloBurnRule": (dict(streak_ticks=5), [
        (0, [], {}, None),
        (0, [], {"slo.firing_streak": [0.0, 3.0]}, None),
        (0, [], {"slo.firing_streak": [4.0, 5.0]}, None)]),
    "ReformBackoffEscalationRule": (dict(failures=2), [
        (5, [(5, "supervisor", "reform_failed", "replica0",
              dict(backoff=1.0))], None, None),
        (6, [(6, "supervisor", "replica_reformed", "replica0", {})],
         None, None),
        (8, [(7, "supervisor", "reform_failed", "replica0",
              dict(backoff=1.0)),
             (8, "supervisor", "reform_failed", "replica0",
              dict(backoff=2.0))], None, None)]),
    "ReplicaOutageRule": (dict(), [
        (5, [(5, "supervisor", "replica_detect", "replica0",
              dict(reason="latency"))], None, None),
        (6, [(6, "supervisor", "replica_detect", "replica0",
              dict(reason="dead"))], None, None),
        (7, [(7, "supervisor", "replica_detect", "replica1",
              dict(reason="slot_leak"))], None, None)]),
}


def _walk_rule(tel, inc, name):
    kwargs, calls = RULES[name]
    rule = getattr(inc, name)(**kwargs)
    out = []
    for tick, events, series, types in calls:
        evs = [_ev(tel, t, lane, kind, subject, **detail)
               for t, lane, kind, subject, detail in events]
        ts = None if series is None else FakeTS(series, types)
        out.append(rule.update(inc.RuleContext(tick, evs, ts)))
    return out


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_verdicts_equal_jax(name):
    ours = _walk_rule(telemetry, incidents, name)
    assert ours == _walk_rule(jax_telemetry, jax_incidents, name)
    assert ours[-1] is not None or name in ("QueueDepthSpikeRule",
                                            "HandoffFailureStreakRule")
    assert any(v is None for v in ours)  # a non-fire path was walked
    assert any(v is not None for v in ours)  # and a fire path


def _ring(tel):
    rec = tel.FlightRecorder(capacity=3)
    for i in range(5):
        rec.record(i, "chaos", "fault_applied", subject=f"index:{i}")
    return (len(rec), rec.recorded, rec.evicted,
            [e.tick for e in rec.events()],
            [e.tick for e in rec.events(last=2)],
            [e.tick for e in rec.events_since(0)],
            [e.tick for e in rec.events_since(4)],
            rec.events_since(7), rec.snapshot(), rec.digest(),
            rec.deterministic_log())


def test_ring_bounds_and_eviction():
    ours = _ring(telemetry)
    assert ours == _ring(jax_telemetry)
    assert ours[:4] == (3, 5, 2, [2, 3, 4])
    with pytest.raises(ValueError):
        telemetry.FlightRecorder(capacity=0)
    for bad in (dict(tick=-1, lane="fleet", kind="fault_applied"),
                dict(tick=0, lane="nope", kind="fault_applied"),
                dict(tick=0, lane="fleet", kind="nope")):
        with pytest.raises(ValueError):
            telemetry.FlightEvent(**bad)
    with pytest.raises(TypeError):
        telemetry.FlightEvent(tick=True, lane="fleet", kind="fault_applied")
    assert telemetry.FLIGHT_KINDS == jax_telemetry.FLIGHT_KINDS
    assert telemetry.FLIGHT_LANES == jax_telemetry.FLIGHT_LANES


def _lifecycle(tel, inc):
    rec = tel.FlightRecorder()
    engine = inc.IncidentEngine(rec, rules=inc.default_rules(),
                                quiet_ticks=3)
    out = [engine.evaluate(0)]
    rec.record(5, "supervisor", "replica_detect", subject="replica0",
               detail={"reason": "dead"})
    out.append(engine.evaluate(5))
    rec.record(5, "fleet", "incident_opened", subject="replica_outage")
    for tick in (6, 7, 8):
        out.append(engine.evaluate(tick))
    out = [([i.to_dict() for i in o], [i.to_dict() for i in c])
           for o, c in out]
    return out, engine.incidents_json(), engine.snapshot()


def test_incident_engine_lifecycle_equals_jax():
    ours = _lifecycle(telemetry, incidents)
    assert ours == _lifecycle(jax_telemetry, jax_incidents)
    assert ours[1]["opened_total"] == ours[1]["closed_total"] == 1


def _story(tel, inc, wall):
    rec = tel.FlightRecorder(clock=lambda: wall)
    rec.record(10, "chaos", "fault_applied", subject="index:0",
               detail={"kind": "replica_crash", "resolved": "replica0"})
    rec.record(11, "supervisor", "replica_detect", subject="replica0",
               detail={"reason": "dead"})
    rec.record(12, "supervisor", "replica_migrate", subject="replica0")
    rec.record(18, "chaos", "recovery_settled",
               detail={"fault_tick": 10, "settled_tick": 18})
    incident = inc.Incident("replica_outage-t000011-n0001",
                            "replica_outage", inc.SEV_CRITICAL, 11,
                            "replica outage: replica0 (dead)")
    bundle = inc.build_bundle(
        incident, rec, metrics_summary={"wall_noise": wall},
        trace_slice=[{"ph": "i", "ts": wall}],
        healthz={"status": "degraded"},
        topology={"tick": 11, "replicas": {"replica0": {"state": "dead"}}})
    chain = inc.cause_chain(rec.events())
    return bundle, chain


def test_bundle_digest_and_cause_chain_equal_jax():
    ours, chain = _story(telemetry, incidents, 1.25)
    ref, ref_chain = _story(jax_telemetry, jax_incidents, 99.0)
    assert ours["digest"] == ref["digest"]
    assert incidents.deterministic_bundle_view(ours) == \
        jax_incidents.deterministic_bundle_view(ref)
    assert chain == ref_chain
    assert incidents.chain_stages(chain) == [
        "fault", "impact", "remediation", "settled"]
    tampered = dict(ours, incident=dict(ours["incident"], reason="edited"))
    assert incidents.bundle_digest(tampered) == \
        jax_incidents.bundle_digest(tampered) != ours["digest"]


def _series(slo_mod, ts_cls, registry_cls):
    """One fake-clocked series fed to both targets kinds."""
    clock = {"t": 0.0}
    values = {"p95": 0.0, "rejected": 0}
    reg = registry_cls()
    reg.register("fleet", lambda: dict(ttft_p95_s=values["p95"],
                                       rejected=values["rejected"]),
                 types={"ttft_p95_s": "gauge", "rejected": "counter"})
    ts = ts_cls(reg, window=64, clock=lambda: clock["t"])
    monitor = slo_mod.SloMonitor([
        slo_mod.SloTarget(name="ttft_p95", metric="fleet.ttft_p95_s",
                          threshold=2.0, budget=0.25, fast_window=1,
                          slow_window=8),
        slo_mod.SloTarget(name="rejection_rate", metric="fleet.rejected",
                          threshold=2.0, kind="rate", fast_window=1,
                          slow_window=4),
        slo_mod.SloTarget(name="floor", metric="fleet.ttft_p95_s",
                          threshold=1.5, mode="min", fast_window=2,
                          slow_window=4),
    ], timeseries=ts)
    verdicts = []
    for tick in range(24):
        clock["t"] = tick * 0.5
        values["p95"] = 3.0 if 6 <= tick < 14 else 1.0
        values["rejected"] += 3 if 10 <= tick < 18 else 0
        ts.sample()
        verdicts.append([a.to_dict() for a in monitor.evaluate()])
    return verdicts, monitor.snapshot(), sorted(monitor.fired_ever)


def test_slo_monitor_equals_jax():
    from skycomputing_tpu.telemetry import MetricsRegistry as JaxRegistry
    from skycomputing_tpu.telemetry import MetricsTimeseries as JaxTS

    ours = _series(slo, telemetry.MetricsTimeseries,
                   telemetry.MetricsRegistry)
    assert ours == _series(jax_slo, JaxTS, JaxRegistry)
    assert ours[2] == ["floor", "rejection_rate", "ttft_p95"]


@pytest.fixture(scope="module")
def fleet_bundles():
    """Replica 0 crashes at tick 5 of a 2-replica fleet with the flight
    recorder attached, after a warmup request per bucket and replica;
    both packages, traced."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gpt = tiny_gpt()
    out = []
    try:
        for side in sides(gpt):
            def run(fleet, requests, side=side):
                for b in (16, 32):
                    for _ in range(2):
                        fleet.submit(side.serving.Request(
                            prompt=list(range(1, b - 1)),
                            max_new_tokens=2))
                fleet.run()
                fleet.attach_flight(quiet_ticks=6)
                fleet.fault_injector = side.injector(
                    [dict(iter=fleet.tick + 3, kind="replica_crash",
                          replica=0)])
                return fleet.run(requests)

            reqs = side.requests(0, [(6, 12)] * 3)
            fleet, _, events = replay(
                side, gpt[0], reqs, run=run, replicas=2,
                engine_kwargs=dict(num_slots=2, max_len=48,
                                   buckets=(16, 32)),
                supervisor=side.supervisor(), devices=side.devices(2))
            out.append((fleet, events))
    finally:
        torch.set_num_threads(torch_threads)
    return out


def test_fleet_incident_bundle_equals_jax(fleet_bundles):
    (jf, _), (pf, pev) = fleet_bundles
    assert not [e for b in jf.bundles for e in b["flight_log"]
                if e["kind"] == "recompile"]
    assert [incidents.deterministic_bundle_view(b) for b in pf.bundles] \
        == [jax_incidents.deterministic_bundle_view(b) for b in jf.bundles]
    assert [b["digest"] for b in pf.bundles] == \
        [b["digest"] for b in jf.bundles]
    assert pf.flight.deterministic_log() == jf.flight.deterministic_log()
    bundle = pf.bundles[0]
    assert bundle["incident"]["rule"] == "replica_outage"
    assert bundle["digest"] == incidents.bundle_digest(bundle)
    stages = incidents.chain_stages(incidents.cause_chain(
        bundle["flight_log"]))
    assert stages and stages[0] == "impact"
    assert pf.stats.incidents_opened == jf.stats.incidents_opened >= 1
    assert pf._incidents_json()["opened_total"] == \
        pf.incidents.opened_total
    assert [e["name"] for e in pev if e.get("name", "").startswith(
        "incident_")]
    snap = pf.metrics.snapshot()
    assert snap["flight"]["flight_recorded"] == pf.flight.recorded


def test_recorder_off_is_zero_cost(monkeypatch):
    gpt = tiny_gpt()
    side = sides(gpt)[1]
    fleet = side.fleet.ServingFleet(
        gpt[0], side.params, replicas=1,
        engine_kwargs=dict(num_slots=2, max_len=48, buckets=(16, 32)),
        devices=side.devices(1))
    assert fleet.flight is None and fleet.incidents is None

    def boom(*a, **k):
        raise AssertionError("flight path entered with recorder off")

    monkeypatch.setattr(side.fleet.ServingFleet, "_flight_tap", boom)
    monkeypatch.setattr(side.fleet.ServingFleet, "_incident_tick", boom)
    for _ in range(3):
        fleet.step()
    assert fleet._health_snapshot()["status"] == "ok"
    assert fleet._incidents_json()["open"] == []
    fleet.attach_flight()
    with pytest.raises(ValueError):
        fleet.attach_flight()


def _write(tmp_path, name, bundle):
    path = tmp_path / name
    path.write_text(json.dumps(bundle))
    return str(path)


def test_skyreport_equals_jax(tmp_path, capsys):
    jax_tool = load_by_path("_test_jax_skyreport", "tools", "skyreport.py")
    bundle, _ = _story(telemetry, incidents, 0.5)
    good = _write(tmp_path, "bundle.json", bundle)
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    cases = [[good], [good, "--format=json"],
             [str(tmp_path / "missing.json")], [str(bad)],
             [_write(tmp_path, "schema.json", dict(bundle,
                                                   schema="other-v0"))],
             [_write(tmp_path, "tampered.json", dict(
                 bundle, incident=dict(bundle["incident"],
                                       reason="edited")))]]
    for argv in cases:
        rc = skyreport.main(argv)
        ours = capsys.readouterr().out
        assert (rc, ours) == (jax_tool.main(argv),
                              capsys.readouterr().out), argv
    assert [skyreport.main(argv) for argv in cases] == [0, 0, 1, 1, 1, 1]
    out = capsys.readouterr().out
    assert "fault -> impact -> remediation -> settled" in out
    assert "DIGEST MISMATCH" in out


def test_trace_report_incident_overlay_equals_jax(tmp_path, capsys):
    jax_tool = load_by_path("_test_jax_trace_report", "tools",
                            "trace_report.py")
    t = {"now": 0.0}
    tracer = telemetry.Tracer(clock=lambda: t["now"])
    stage = tracer.lane("stage 0 [cpu]", "dispatch")
    t["now"] = 1e-3
    tracer.complete("fwd", stage, 0.0)
    tracer.instant("incident_opened", tracer.lane("fleet", "incidents"),
                   {"rule": "replica_outage", "incident": "i-1"})
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(tracer.to_chrome()))
    bundle = _write(tmp_path, "bundle.json",
                    _story(telemetry, incidents, 0.5)[0])
    argv = [str(trace), "--incidents", bundle, "--json"]
    assert trace_report.main(argv) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_tool.main(argv) == 0
    ref = json.loads(capsys.readouterr().out)
    assert ours["incidents"] == ref["incidents"]
    assert [m["name"] for m in ours["incidents"]["marks"]] == [
        "incident_opened"]
    assert trace_report.main(argv[:2] + [bundle]) == 0
    human = capsys.readouterr().out
    assert "# incident replica_outage-t000011-n0001" in human
    missing = [str(trace), "--incidents", str(tmp_path / "nope.json")]
    assert trace_report.main(missing) == jax_tool.main(missing) == 1
    assert Path(bundle).exists()
