"""``python -m skycomputing_tpu_torch.tools.bench_fleet`` against the JAX
package's ``tools/bench_fleet.py``: the kill-and-spike scenario cut to
3 bursts and 8 spike requests, through both packages on the same seed
and weights (JAX's bench model, its weights converted).  Exact: every
accepted stream, ``fleet_stats`` with rejects by reason, and the
supervisor's ``(kind, replica, tick)`` events.  The JAX side replays the reference bench's phases
with the JAX package's fleet (the tool fixes its sizes); both fleets
route on depth, judge sickness at an infinite threshold, and clock the
SLO time series by fleet ticks (``tests/torch_fleet_helpers.py``), and
the bench's TTFT target (a wall-clock percentile) is held out of both
runs, so no host timing reaches a compared decision.  The command's own
runs: ``--device cpu`` end to end and no card without it."""

import json

import numpy as np
import pytest
import torch

import jax

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.dynamics import FaultPlan, FleetFaultInjector
from skycomputing_tpu.fleet import (
    AdmissionController,
    FleetSupervisor,
    ServingFleet,
)
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.serving import Request
from skycomputing_tpu.telemetry.slo import SloMonitor, SloTarget
from skycomputing_tpu.workload import mixes
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.telemetry.slo import SloTarget as PortTarget
from skycomputing_tpu_torch.tools import bench_fleet
from torch_fleet_helpers import depth_router, sides, supervisor_events

pytestmark = pytest.mark.torch_port

SEED, N_BURSTS, N_SPIKE = 0, 3, 8
SUPERVISOR = dict(bench_fleet.SUPERVISOR, sick_threshold=float("inf"))


def _targets(cls):
    """The bench's rejection-rate target (per fleet tick here)."""
    return [cls(name="rejection_rate", metric="fleet.rejected",
                threshold=2.0, kind="rate", fast_window=1, slow_window=8)]


def _jax_bench(layer_cfgs, params, router):
    """``tools/bench_fleet.py``'s phases at the cut sizes."""
    rng = np.random.default_rng(SEED)
    fleet = ServingFleet(
        layer_cfgs, params, replicas=3,
        engine_kwargs=dict(bench_fleet.ENGINE),
        admission=AdmissionController(max_pending=12),
        supervisor=FleetSupervisor(**SUPERVISOR),
        router=router,
        devices=jax.devices()[:3])
    fleet.enable_timeseries(window=4096, clock=lambda: float(fleet.tick))
    fleet.attach_slo(SloMonitor(_targets(SloTarget)))
    for _ in range(3):
        for b in (32, 64, 96):
            fleet.submit(Request(
                prompt=rng.integers(1, 500, (b - 2,)).astype(np.int32),
                max_new_tokens=2))
    fleet.run()
    burst, gap = 8, 32
    tick0 = fleet.tick
    kill = tick0 + gap * (N_BURSTS // 2) + gap // 2
    fleet.fault_injector = FleetFaultInjector(FaultPlan(
        [dict(iter=kill, kind="replica_crash", replica=0)], seed=SEED))
    arrivals = [(t, Request(prompt=p, max_new_tokens=n))
                for t, (p, n) in mixes.fleet_bursty_arrivals(
                    rng, n=burst * N_BURSTS, burst=burst, gap=gap,
                    start=tick0)]
    accepted, i = [], 0
    while i < len(arrivals) or fleet.has_work():
        while i < len(arrivals) and arrivals[i][0] <= fleet.tick:
            if fleet.submit(arrivals[i][1]).admitted:
                accepted.append(arrivals[i][1])
            i += 1
        fleet.step()
    spike = [Request(prompt=p, max_new_tokens=n)
             for p, n in mixes.fleet_spike_specs(rng, n=N_SPIKE)]
    j = 0
    while j < len(spike) or fleet.has_work():
        for _ in range(2):
            if j < len(spike):
                if fleet.submit(spike[j]).admitted:
                    accepted.append(spike[j])
                j += 1
        fleet.step()
    return fleet, accepted


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = GptConfig(**bench_fleet.MODEL)
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(SEED),
                                        np.ones((1, 8), np.int32))
    sds = params_from_jax(jax.device_get(params), layer_cfgs)
    jax_side, port_side = sides((layer_cfgs, params, sds))
    try:
        jf, jacc = _jax_bench(layer_cfgs, params, depth_router(jax_side))
        clock = {}
        report, pf, pacc = bench_fleet.run_scenario(
            device="cpu", seed=SEED, params=sds, n_bursts=N_BURSTS,
            n_spike=N_SPIKE, supervisor_kwargs=SUPERVISOR,
            router=depth_router(port_side),
            slo_targets=_targets(PortTarget),
            timeseries_clock=lambda: float(clock["fleet"].tick),
            setup=lambda fleet: clock.update(fleet=fleet))
    finally:
        torch.set_num_threads(threads)
    return (jf, jacc), (report, pf, pacc)


def test_kill_and_spike_equals_jax(runs):
    (jf, jacc), (report, pf, pacc) = runs
    assert [r.output().tolist() for r in pacc] == \
        [r.output().tolist() for r in jacc]
    assert report["fleet_stats"] == jf.stats.snapshot() == \
        pf.stats.snapshot()
    # (kind, replica, tick): a detect's health score is a wall-clock
    # EWMA ratio, reported but not compared
    assert [(e["kind"], e["replica"], e["tick"])
            for e in report["supervisor_events"]] == supervisor_events(jf)
    assert report["gates"]["token_identical"] is True
    assert report["gates"]["zero_lost_tokens"] is True
    assert report["gates"]["replica_reformed"] is True
    assert report["fleet_stats"]["migrations"] >= 1
    # 8 spike requests stay inside the pending bound of 12: the cut run
    # sheds nothing, and says so in both packages
    assert report["spike"]["rejected"] == sum(
        report["spike"]["rejected_by_reason"].values()) == \
        jf.stats.rejected
    assert report["device"]["platform"] == "cpu"
    assert not report["identity_findings"]


def test_command_on_the_cpu_and_no_card(tmp_path, capsys, monkeypatch):
    """The command's default run writes its report and exits by its
    gates (the timing gates read this host's clock); without
    ``--device`` a box with no card raises."""
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    out = tmp_path / "fleet.json"
    captured = {}
    real = bench_fleet.run_scenario

    def cut(**kw):
        captured.update(kw)
        return real(**dict(kw, n_bursts=N_BURSTS, n_spike=N_SPIKE))

    monkeypatch.setattr(bench_fleet, "run_scenario", cut)
    rc = bench_fleet.main(["--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["passed"] else 1)
    assert captured["device"] == torch.device("cpu")
    assert report["bench"] == "fleet_kill_and_spike"
    assert "# PASS" in capsys.readouterr().out or not report["passed"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_fleet.main(["--out", str(out)])
