"""The port's workload plane (``workload/scenario.py``, ``catalog.py``,
``player.py``) against the JAX package's: every catalog scenario at
seeds 0, 1 and 7 gives the same ``digest()``, ``trace_digest`` and
``to_dict()``; every malformed ``Dist`` / ``Phase`` / ``Scenario`` of
``tests/test_workload.py`` is refused with JAX's message; the scenario
module loads by file path with torch and numpy blocked; the player on
the port's engine and fleet (the CPU, plain versions, JAX's weights)
gives JAX's verdicts and streams; and ``bench_scenarios`` runs at
``--device cpu`` under its gates and refuses without a card."""

import json
from pathlib import Path

import pytest
import torch

from skycomputing_tpu import workload as jax_workload
from skycomputing_tpu.workload import scenario as jax_scenario
from skycomputing_tpu_torch import workload as port_workload
from skycomputing_tpu_torch.tools import bench_scenarios
from skycomputing_tpu_torch.workload import scenario as port_scenario
from torch_fleet_helpers import (
    port_generate_identity,
    sides,
    stdlib_load,
    tiny_gpt,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

WORKLOAD = {"jax": jax_workload, "port": port_workload}
REPO = Path(__file__).resolve().parents[1]


def _view(mod, name, seed):
    s = mod.get_scenario(name, seed=seed)
    arrivals = s.arrivals()
    return dict(digest=s.digest(), trace=mod.trace_digest(arrivals),
                keys=[a.key() for a in arrivals], doc=s.to_dict(),
                ticks=s.total_ticks, max_prompt=s.max_prompt_len,
                max_new=s.max_new_tokens)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", jax_scenario.scenario_names())
def test_catalog_scenario_equals_jax(name, seed):
    assert _view(port_scenario, name, seed) == \
        _view(jax_scenario, name, seed)


def test_catalog_names_and_exports_equal_jax():
    assert port_workload.scenario_names() == \
        jax_workload.scenario_names()
    assert set(port_workload.__all__) == set(jax_workload.__all__)
    assert port_workload.catalog.get_scenario is port_scenario.get_scenario
    with pytest.raises(ValueError, match="catalog"):
        port_workload.get_scenario("nope")


def _tiny(mod, seed=3, rate=1.0, ticks=8):
    """tests/test_workload.py's tiny scenario."""
    return mod.Scenario(
        name="tiny", seed=seed,
        phases=(mod.Phase(
            name="only", ticks=ticks, arrival_rate=rate,
            prompt_len=mod.Dist.uniform(4, 12),
            new_tokens=mod.Dist.uniform(2, 4),
            priority_mix=(("interactive", 0.5), ("batch", 0.5))),),
        vocab=(1, 500))


BAD = {
    "uniform_order": lambda m: m.Dist.uniform(5, 2),
    "constant_zero": lambda m: m.Dist.constant(0),
    "choice_weights": lambda m: m.Dist.choice((2,), weights=(1.0, 2.0)),
    "priority": lambda m: m.Phase(
        name="p", ticks=4, arrival_rate=1.0,
        prompt_len=m.Dist.constant(4), new_tokens=m.Dist.constant(2),
        priority_mix=(("vip", 1.0),)),
    "prefix_pool": lambda m: m.Scenario(name="s", seed=0, phases=(
        m.Phase(name="p", ticks=4, arrival_rate=1.0,
                prompt_len=m.Dist.constant(4),
                new_tokens=m.Dist.constant(2),
                shared_prefix=("nope", 0.5)),)),
    "vocab": lambda m: m.Scenario(name="s", seed=0, vocab=(5, 5), phases=(
        m.Phase(name="p", ticks=1, arrival_rate=1.0,
                prompt_len=m.Dist.constant(4),
                new_tokens=m.Dist.constant(2)),)),
    "no_phases": lambda m: m.Scenario(name="s", seed=0, phases=()),
    "negative_rate": lambda m: m.Phase(
        name="p", ticks=4, arrival_rate=-1.0,
        prompt_len=m.Dist.constant(4), new_tokens=m.Dist.constant(2)),
}


def _refusal(build, mod):
    with pytest.raises(ValueError) as info:
        build(mod)
    return str(info.value)


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_refusals_equal_jax(case):
    assert _refusal(BAD[case], port_scenario) == \
        _refusal(BAD[case], jax_scenario)


def test_tiny_scenario_accumulator_equals_jax():
    ours, theirs = (_tiny(m, seed=11, rate=0.5, ticks=10)
                    for m in (port_scenario, jax_scenario))
    assert [a.tick for a in ours.arrivals()] == [1, 3, 5, 7, 9]
    assert [a.key() for a in ours.arrivals()] == \
        [a.key() for a in theirs.arrivals()]
    assert ours.digest() == theirs.digest()
    assert ours.with_seed(12).digest() == theirs.with_seed(12).digest()


def test_scenario_module_is_stdlib_only():
    path = Path(port_scenario.__file__)
    got = stdlib_load(path, "[mod.get_scenario(n, seed=1).digest() "
                            "for n in mod.scenario_names()]")
    assert got == [jax_scenario.get_scenario(n, seed=1).digest()
                   for n in jax_scenario.scenario_names()]


# --------------------------------------------------------------------------
# the player against real targets
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt():
    return tiny_gpt()


def _verdicts(report):
    return [dict(v.to_dict(), request_id=None, ttft_s=None, tpot_s=None,
                 retry_after_s=v.retry_after_s is not None
                 and v.retry_after_s > 0)
            for v in report.verdicts]


def test_player_on_engine_equals_jax(gpt):
    layer_cfgs, _, sds = gpt
    out = []
    for side in sides(gpt):
        mod = WORKLOAD[side.name]
        scenario = _tiny(mod.scenario, seed=3, rate=1.0, ticks=8)
        kw = dict(num_slots=2, max_len=64, buckets=(16, 32),
                  prefill_batch=1)
        if side.name == "port":
            kw["devices"] = [torch.device("cpu")]
        engine = side.serving.ServingEngine(layer_cfgs, side.params, **kw)
        player = mod.ScenarioPlayer(scenario, engine)
        assert not player.priority_aware
        report = player.play()
        out.append((report, engine))
    (jr, je), (pr, pe) = out
    assert pr.digest == jr.digest
    assert pr.ticks_run == jr.ticks_run
    assert _verdicts(pr) == _verdicts(jr)
    assert [v.request.output().tolist() for v in pr.verdicts] == \
        [v.request.output().tolist() for v in jr.verdicts]
    assert len(pr.finished) == len(pr.verdicts)
    reqs = [v.request for v in pr.verdicts]
    port_generate_identity(layer_cfgs, sds, reqs,
                           {r.request_id: r.output() for r in reqs})
    summary = pr.summary()
    assert summary["total"]["finished"] == len(pr.verdicts)
    assert {k: v for k, v in summary["total"].items()
            if not k.endswith("_s")} == \
        {k: v for k, v in jr.summary()["total"].items()
         if not k.endswith("_s")}


def test_player_records_fleet_rejections_like_jax(gpt):
    layer_cfgs = gpt[0]
    out = []
    for side in sides(gpt):
        mod = WORKLOAD[side.name]
        fleet = side.fleet.ServingFleet(
            layer_cfgs, side.params, replicas=1,
            engine_kwargs=dict(num_slots=2, max_len=64, buckets=(16, 32),
                               prefill_batch=1),
            admission=side.fleet.AdmissionController(max_pending=2),
            devices=side.devices(1))
        ticks = [0]
        player = mod.ScenarioPlayer(
            _tiny(mod.scenario, seed=9, rate=3.0, ticks=4), fleet,
            sample_fn=lambda: ticks.__setitem__(0, ticks[0] + 1) or {})
        assert player.priority_aware
        report = player.play()
        out.append((report, fleet, ticks[0]))
    (jr, jf, jt), (pr, pf, pt) = out
    assert pr.rejected and _verdicts(pr) == _verdicts(jr)
    assert all(v.retry_after_s > 0 and v.request.status == "rejected"
               for v in pr.rejected)
    assert [v.request.output().tolist() for v in pr.verdicts] == \
        [v.request.output().tolist() for v in jr.verdicts]
    assert pr.ticks_run == pt == jr.ticks_run == jt
    assert pf.stats.snapshot() == jf.stats.snapshot()


# --------------------------------------------------------------------------
# the command
# --------------------------------------------------------------------------


def test_command_list_equals_jax(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_bench_scenarios", REPO / "tools" / "bench_scenarios.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert bench_scenarios.main(["--list"]) == 0
    ours = capsys.readouterr().out
    assert jax_tool.main(["--list"]) == 0
    assert ours == capsys.readouterr().out


def test_command_on_the_cpu_and_no_card(tmp_path, monkeypatch, capsys):
    """``flash_crowd`` (the universal gates; the scale gates judge
    ``diurnal_ramp`` only) at ``--device cpu``: the exit code is the
    gates', the JSON the reference bench's schema; without ``--device``
    a box with no card raises."""
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    out = tmp_path / "scenarios.json"
    rc = bench_scenarios.main(["--device", "cpu", "--scenario",
                               "flash_crowd", "--epilogue", "10",
                               "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["passed"] else 1)
    assert {"bench", "device_kind", "model", "fleet", "autoscaler",
            "scenario", "digest", "notes", "runs", "scaling_verdicts",
            "gates", "passed"} <= set(report)
    assert report["bench"] == "scenario_autoscaler"
    assert set(report["gates"]) == {"zero_lost_tokens", "token_identical",
                                    "workload_replayable",
                                    "rejections_visible"}
    assert report["passed"] and rc == 0
    assert report["digest"] == \
        jax_scenario.get_scenario("flash_crowd").digest()
    assert "# PASS" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_scenarios.main([])
