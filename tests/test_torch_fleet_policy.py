"""The fleet's pure decision logic and its workload, port against the
JAX package: the router's ranking, choice and affinity and the
admission controller's decisions, reasons and ``retry_after_s`` on the
synthetic snapshots of ``tests/test_fleet.py`` and of
``tools/bench_fleet.py``'s smoke, exactly; ``bench_fleet --smoke``
exiting as JAX's does; the fleet mixes drawing JAX's bytes at equal
seed; ``FleetFaultInjector``'s vocabulary and seeded spike draws."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from skycomputing_tpu.dynamics import FaultPlan as JaxFaultPlan
from skycomputing_tpu.dynamics import FleetFaultInjector as JaxInjector
from skycomputing_tpu.fleet import admission as jax_admission
from skycomputing_tpu.fleet import router as jax_router
from skycomputing_tpu.workload import mixes as jax_mixes
from skycomputing_tpu_torch.dynamics import (
    FaultInjectionHook,
    FaultPlan,
    FleetFaultInjector,
)
from skycomputing_tpu_torch.fleet import admission, router
from skycomputing_tpu_torch.tools import bench_fleet
from skycomputing_tpu_torch.workload import mixes

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]


def snap(name, healthy=True, slots=4, free=4, depth=0, tpot=None, role=""):
    return dict(name=name, healthy=healthy, slots=slots, free_slots=free,
                queue_depth=depth, tpot_p95_s=tpot, role=role)


def _skew(mod):
    r = mod.Router()
    snaps = [snap("a", depth=5, free=0), snap("b", free=2), snap("c")]
    return [r.choose(snaps), r.rank(snaps),
            r.choose([snap("a", free=0, tpot=0.5),
                      snap("b", free=0, tpot=0.01)]),
            r.rank([snap("a", healthy=False), snap("b")]),
            r.choose([snap("a", healthy=False)]),
            mod.replica_load(snap("a", free=1, depth=2, tpot=0.2)),
            mod.replica_load(snap("a", free=1, depth=2), 0.7)]


def _affinity(mod):
    r = mod.Router(affinity_slack=2.0)
    prompt = list(range(1, 12))
    out = [r.choose([snap("a"), snap("b")], prompt)]
    r.record_dispatch("b", prompt)
    out += [r.choose([snap("a"), snap("b", free=2)], prompt),
            r.choose([snap("a"), snap("b", free=0, depth=3)], prompt),
            r.choose([snap("a"), snap("b", free=2)], list(range(50, 60))),
            r.forget_replica("b"),
            r.choose([snap("a"), snap("b", free=2)], prompt),
            mod.prefix_key(prompt), mod.prefix_key(prompt, 3)]
    return out


def _paged_affinity(mod):
    r = mod.Router(page_size=4, affinity_slack=8.0)
    prompt = list(range(7, 20))
    r.record_dispatch("b", prompt)
    return [mod.radix_prefix_key(prompt, 4), mod.radix_prefix_key([1], 4),
            r.choose([snap("a"), snap("b", free=0, depth=6)],
                     prompt[:4] + [99]),
            r.rank([snap("a", role="prefill"), snap("b", role="decode")],
                   role="decode")]


def _smoke_router(mod):
    r = mod.Router(affinity_slack=2.0)
    out = [r.rank([snap("a", depth=6, free=0), snap("b", free=1),
                   snap("c")])]
    r.record_dispatch("b", list(range(1, 12)))
    out += [r.choose([snap("a"), snap("b", free=2)], list(range(1, 12))),
            r.choose([snap("a"), snap("b", free=0, depth=4)],
                     list(range(1, 12)))]
    return out


def _decision(d):
    return (d.admitted, d.reason, d.retry_after_s, d.replica,
            sorted(d.detail.items()))


def _admission_bounds(mod):
    adm = mod.AdmissionController(max_pending=8, shed_fraction=0.5,
                                  service_s_estimate=0.1)
    calls = [dict(pending=0, capacity_slots=4),
             dict(pending=8, capacity_slots=4),
             dict(pending=16, capacity_slots=4),
             dict(pending=5, capacity_slots=4, priority="batch"),
             dict(pending=5, capacity_slots=4, priority="interactive"),
             dict(pending=3, capacity_slots=1, deadline_s=0.05),
             dict(pending=3, capacity_slots=1, deadline_s=10.0),
             dict(pending=0, capacity_slots=0),
             dict(pending=6, capacity_slots=3, tpot_p50_s=0.02),
             dict(pending=2, capacity_slots=2, deadline_s=0.01,
                  tpot_p50_s=0.03)]
    out = [_decision(adm.decide(**c)) for c in calls]
    auto = mod.AdmissionController(queue_factor=2.0)
    out += [auto.pending_bound(8), auto.pending_bound(4),
            auto.estimate_wait_s(7, 3, None), auto.estimate_wait_s(7, 3, 0.2)]
    return out


def _admission_scaling(mod):
    class Firing:
        firing = ("ttft",)

    adm = mod.AdmissionController(max_pending=8)
    out = [adm.pending_bound(2), adm.pending_bound(16)]
    adm.baseline_capacity = 4
    out += [adm.pending_bound(c) for c in (4, 8, 2, 0)]
    adm.slo_monitor = Firing()
    out += [adm.pending_bound(4), _decision(adm.decide(pending=4,
                                                       capacity_slots=4))]
    adm.slo_monitor = None
    adm.blip_active = True
    out.append(_decision(adm.decide(pending=0, capacity_slots=4)))
    tight = mod.AdmissionController(queue_factor=2.0,
                                    slo_monitor=Firing(), slo_tighten=0.25)
    out += [tight.pending_bound(8), tight.pending_bound(0)]
    return out


CASES = [_skew, _affinity, _paged_affinity, _smoke_router]
ADMISSION = [_admission_bounds, _admission_scaling]


@pytest.mark.parametrize(
    "case", CASES + ADMISSION,
    ids=[f.__name__[1:] for f in CASES + ADMISSION])
def test_decisions_equal_jax(case):
    ours, ref = ((router, jax_router) if case in CASES
                 else (admission, jax_admission))
    assert case(ours) == case(ref)


def _jax_bench_fleet():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_fleet", REPO / "tools" / "bench_fleet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_exits_as_jax(capsys, monkeypatch):
    assert bench_fleet.main(["--smoke"]) == _jax_bench_fleet().main(
        ["--smoke"]) == 0
    assert "# smoke: ok" in capsys.readouterr().out
    # a policy that drifts (here: ranks by name, load ignored) fails it
    monkeypatch.setattr(
        router.Router, "rank",
        lambda self, snaps, prompt=None, role=None: sorted(
            s["name"] for s in snaps if s.get("healthy")))
    assert bench_fleet.run_smoke() == 1


def _draws(mod, seed):
    rng = np.random.default_rng(seed)
    arrivals = mod.fleet_bursty_arrivals(rng, n=20, burst=8, gap=32,
                                         start=9)
    spike = mod.build_mix("fleet_spike", rng, n=7, prompt_hi=40)
    one = mod.fleet_request_spec(rng, vocab=300)
    flat = [(t, p.tobytes(), p.dtype.str, n) for t, (p, n) in arrivals]
    flat += [(p.tobytes(), p.dtype.str, n) for p, n in spike + [one]]
    return flat, sorted(mod.MIXES)


@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_mixes_byte_identical(seed):
    assert _draws(mixes, seed) == _draws(jax_mixes, seed)


def test_fleet_fault_vocabulary():
    with pytest.raises(ValueError, match="missing required field"):
        FaultPlan([dict(iter=0, kind="slot_leak")])
    fleet_plan = FaultPlan([dict(iter=0, kind="replica_crash", replica=0)])
    with pytest.raises(ValueError, match="FleetFaultInjector"):
        FaultInjectionHook(fleet_plan)
    with pytest.raises(ValueError, match="FaultInjectionHook"):
        FleetFaultInjector(FaultPlan(
            [dict(iter=0, kind="slowdown", worker=0, factor=2.0)]))
    injector = FleetFaultInjector(FaultPlan(
        [dict(iter=40, kind="replica_crash", replica=7)]))

    class _Fleet:
        tick = 0
        replicas = [object(), object()]

    with pytest.raises(ValueError, match="replica indices \\[7\\]"):
        injector.on_tick(_Fleet())


def _spike_draws(plan_cls, injector_cls):
    """A ``latency_spike`` that leaves ``seconds`` open, and a slot leak
    against a pool with one free slot: what each injector applies."""
    stalls = []

    class _Replica:
        name = "r0"

        def inject_stall(self, seconds, clear_at_tick=None):
            stalls.append((seconds, clear_at_tick))

        def leak_slots(self, count):
            return 1

        def crash(self):
            stalls.append("crash")

    class _Fleet:
        replicas = [_Replica()]

        def replica_by_index(self, i):
            return self.replicas[i]

    injector = injector_cls(plan_cls(
        [dict(iter=0, kind="latency_spike", replica=0, duration=3),
         dict(iter=1, kind="slot_leak", replica=0, count=4),
         dict(iter=2, kind="replica_crash", replica=0)], seed=11))
    fleet = _Fleet()
    for tick in range(3):
        fleet.tick = tick
        injector.on_tick(fleet)
    return stalls, injector.applied


def test_fleet_injector_applies_jax_draws():
    ours = _spike_draws(FaultPlan, FleetFaultInjector)
    assert ours == _spike_draws(JaxFaultPlan, JaxInjector)
    assert ours[0][0][0] > 0 and ours[1][1]["leaked"] == 1
