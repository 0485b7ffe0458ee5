"""Scenario bench: the autoscaler riding named workloads, gated (the port
of ``tools/bench_scenarios.py``).

The acceptance scenario is ``diurnal_ramp``: a quiet night, a morning
ramp, a midday peak that overloads the boot-time fleet, an evening
decay.  The bench runs it twice:

- **autoscaled**: one replica and a ``FleetAutoscaler`` (chip budget:
  three replicas' worth of the one device the bench is given).
  Sustained SLO burn at the peak must ADD replicas through the verified
  re-form path; sustained slack after it must drain and REMOVE them back
  to ``min_replicas``;
- **fixed baseline**: the same fleet without an autoscaler, on the same
  arrival trace (digests compared).

The SLO target is queue pressure (``fleet.queue_depth`` above 4), a
count, so the burn verdict does not read the host's clock.

Gates, in the JSON written to ``--out``:

- the autoscaler scaled UP under the peak's burn and back DOWN after it
  (ending at ``min_replicas``);
- SLO burn bounded against the baseline: the autoscaled run burns no
  more ticks per request served than the fixed fleet, and serves at
  least as many requests to completion;
- zero lost tokens: every admitted request finishes, token-identical to
  the one-shot ``generate`` (a mismatch lands in ``identity_findings``);
- both runs saw the same trace, and every rejection carries a reason.

Any catalog scenario runs through the same harness with ``--scenario``
(the scale gates apply to ``diurnal_ramp``, the one scenario sized to
demand both directions).  The model is the reference bench's tiny GPT
(2 blocks, hidden 64) with random weights from ``--seed``;
:func:`run_bench` takes the model config, the weights, the engine's and
the supervisor's kwargs as arguments.  Runs on the card unless
``--device`` names another device (raising on a box without one);
``--list`` needs no device.

Usage::

    python -m skycomputing_tpu_torch.tools.bench_scenarios --list
    python -m skycomputing_tpu_torch.tools.bench_scenarios \\
        [--device cpu] [--scenario NAME] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional, Sequence

from ..workload import catalog

#: the reference bench's model (``tools/bench_scenarios.py``)
MODEL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=160,
             dropout_prob=0.0, dtype="float32")
ENGINE = dict(num_slots=2, max_len=128, buckets=(32, 64, 96),
              prefill_batch=1)
SUPERVISOR = dict(check_every=1, heartbeat_misses=1, sick_threshold=8.0,
                  k_checks=3)
AUTOSCALER = dict(min_replicas=1, max_replicas=3, up_streak=3,
                  down_streak=30, cooldown_ticks=20, slack_utilization=0.35)


def list_scenarios() -> int:
    for name in catalog.scenario_names():
        s = catalog.get_scenario(name)
        print(f"{name:20s} ticks={s.total_ticks:4d} "
              f"arrivals={len(s.arrivals()):4d} "
              f"max_prompt={s.max_prompt_len:3d}  {s.description}")
    return 0


def _burn_ticks(timeline) -> int:
    return sum(1 for t in timeline if t.get("firing"))


def _play(scenario, fleet, slo, epilogue: int):
    """One replay and an idle epilogue (scale-downs land in the quiet
    tail)."""
    from ..workload import ScenarioPlayer

    def probe():
        return dict(tick=fleet.tick,
                    healthy=len(fleet.healthy_replicas),
                    replicas=len(fleet.replicas),
                    pending=fleet.stats.pending,
                    firing=len(slo.firing) if slo is not None else 0)

    player = ScenarioPlayer(scenario, fleet, sample_fn=probe)
    t0 = time.perf_counter()
    report = player.play()
    for _ in range(int(epilogue)):
        fleet.step()
        report.timeline.append(probe())
    report.wall_s = time.perf_counter() - t0
    return report


def run_bench(
    scenario_name: str = "diurnal_ramp",
    *,
    device=None,
    seed: int = 0,
    epilogue: int = 130,
    model: Optional[Dict[str, Any]] = None,
    params: Optional[Sequence[Any]] = None,
    engine_kwargs: Optional[Dict[str, Any]] = None,
    supervisor_kwargs: Optional[Dict[str, Any]] = None,
):
    """Autoscaled and fixed replays of ``scenario_name``; returns
    ``(report, runs)`` with ``runs[mode]`` the ``(fleet, slo,
    autoscaler, player report)`` of each.

    ``model`` (a ``GptConfig`` dict, default :data:`MODEL`) is built
    with ``params`` or random weights from ``seed``; ``engine_kwargs``
    default to :data:`ENGINE`, ``supervisor_kwargs`` to
    :data:`SUPERVISOR`."""
    import numpy as np

    from ..bench_serving import _identical, _one_shot
    from ..fleet import FleetAutoscaler, FleetSupervisor, ServingFleet
    from ..models.gpt import GptConfig, gpt_layer_configs, random_state_dicts
    from ..serving import Request
    from ..telemetry.slo import SloMonitor, SloTarget
    from ..utils import resolve_device
    from . import device_record

    dev = resolve_device(device)
    scenario = catalog.get_scenario(scenario_name, seed=seed)
    cfg = GptConfig(**dict(model or MODEL))
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    if params is None:
        print(f"initializing {len(layer_cfgs)}-layer GPT "
              f"(hidden={cfg.hidden_size})...", flush=True)
        params = random_state_dicts(layer_cfgs, seed)
    engine = dict(ENGINE if engine_kwargs is None else engine_kwargs)
    sup_kw = dict(SUPERVISOR if supervisor_kwargs is None
                  else supervisor_kwargs)
    buckets = tuple(engine["buckets"])
    worst = scenario.max_prompt_len + scenario.max_new_tokens
    if worst > max(buckets):
        raise SystemExit(
            f"scenario {scenario.name} needs {worst} positions but the "
            f"bench buckets top out at {max(buckets)}")
    chips = AUTOSCALER["max_replicas"]

    def make_fleet(autoscaled: bool):
        auto = FleetAutoscaler(**AUTOSCALER) if autoscaled else None
        fleet = ServingFleet(layer_cfgs, params, replicas=1,
                             engine_kwargs=dict(engine),
                             supervisor=FleetSupervisor(**sup_kw),
                             autoscaler=auto, devices=[dev] * chips)
        # warm-up first, outside every SLO window (added replicas warm
        # on live traffic)
        fleet.run([Request(prompt=np.full((b - 2,), b + 1, np.int32),
                           max_new_tokens=2) for b in buckets])
        fleet.reset_slo_windows()
        fleet.enable_timeseries(window=4096)
        slo = fleet.attach_slo(SloMonitor([
            # sustained queued-but-unserved backlog past 2x one
            # replica's slots: arrivals outpace service
            SloTarget(name="queue_pressure", metric="fleet.queue_depth",
                      threshold=4, budget=0.25, fast_window=1,
                      slow_window=8)]))
        return fleet, slo, auto

    runs, measured = {}, {}
    for mode in ("autoscaled", "fixed"):
        print(f"running {scenario.name} [{mode}]...", flush=True)
        fleet, slo, auto = make_fleet(autoscaled=mode == "autoscaled")
        report = _play(scenario, fleet, slo,
                       epilogue if mode == "autoscaled" else 0)
        measured[mode] = (fleet, slo, auto, report)
        summary = report.summary()
        generated = sum(len(v.request.tokens) for v in report.finished)
        runs[mode] = dict(
            summary=summary,
            burn_ticks=_burn_ticks(report.timeline),
            peak_healthy=max((t["healthy"] for t in report.timeline),
                             default=0),
            final_replicas=len(fleet.replicas),
            wall_s=report.wall_s,
            generated_tokens=generated,
            fleet_stats=fleet.stats.snapshot(),
            slo=dict(fired_ever=sorted(slo.fired_ever),
                     alerts_total=slo.alerts_total,
                     evaluations=slo.evaluations),
            autoscaler_events=(list(auto.events) if auto else []),
        )
        print(f"  {mode}: finished {summary['total']['finished']}/"
              f"{summary['total']['arrivals']}, burn_ticks="
              f"{runs[mode]['burn_ticks']}, replicas peak "
              f"{runs[mode]['peak_healthy']} final "
              f"{runs[mode]['final_replicas']}", flush=True)

    one_shot = _one_shot(layer_cfgs, params, dev,
                         cfg.max_position_embeddings)
    findings: list = []

    def identity_ok(report) -> bool:
        reqs = [v.request for v in report.finished]
        return _identical({r.request_id: r.output() for r in reqs}, reqs,
                          one_shot, findings)

    auto_fleet, _, auto_ctl, auto_report = measured["autoscaled"]
    base_fleet, _, _, base_report = measured["fixed"]
    auto_sum = runs["autoscaled"]["summary"]
    base_sum = runs["fixed"]["summary"]
    zero_lost = (
        len(auto_report.finished) == len(auto_report.admitted)
        and auto_fleet.stats.failed == 0
        and len(base_report.finished) == len(base_report.admitted)
        and base_fleet.stats.failed == 0)
    universal = dict(
        zero_lost_tokens=bool(zero_lost),
        token_identical=bool(identity_ok(auto_report)
                             and identity_ok(base_report)),
        workload_replayable=bool(auto_report.digest == base_report.digest),
        rejections_visible=bool(
            auto_fleet.stats.rejected
            == sum(auto_fleet.stats.rejected_by_reason.values())),
    )
    for mode in runs:
        served = runs[mode]["summary"]["total"]["finished"]
        runs[mode]["burn_per_served"] = (
            runs[mode]["burn_ticks"] / served if served else None)
    scaling = dict(
        scaled_up_under_burn=bool(auto_fleet.stats.scale_ups >= 1
                                  and runs["autoscaled"]["peak_healthy"]
                                  > 1),
        scaled_down_after=bool(
            auto_fleet.stats.scale_downs >= 1
            and runs["autoscaled"]["final_replicas"]
            == auto_ctl.min_replicas),
        # the fixed fleet "avoids" burn by shedding: the fair bound is
        # burn ticks per request served, the served count gated apart
        slo_burn_bounded=bool(
            runs["fixed"]["burn_ticks"] >= 1
            and auto_sum["total"]["finished"] > 0
            and base_sum["total"]["finished"] > 0
            and runs["autoscaled"]["burn_per_served"]
            <= runs["fixed"]["burn_per_served"]),
        served_no_worse=bool(auto_sum["total"]["finished"]
                             >= base_sum["total"]["finished"]),
    )
    gates = dict(universal)
    if scenario.name == "diurnal_ramp":
        gates.update(scaling)
    passed = all(gates.values())
    record = device_record(dev)
    report_doc = dict(
        bench="scenario_autoscaler",
        device_kind=record["kind"],
        device=record,
        model=dict(cfg.to_dict()),
        fleet=dict(initial_replicas=1, **engine),
        autoscaler=dict(AUTOSCALER, chip_capacity=chips,
                        epilogue_ticks=epilogue),
        scenario=scenario.to_dict(),
        digest=auto_report.digest,
        notes=(
            "every replica on the one device; added replicas serve their "
            "first requests on live traffic; the fixed baseline runs the "
            "same trace"
        ),
        runs=runs,
        scaling_verdicts=scaling,
        identity_findings=findings,
        gates=gates,
        passed=passed,
    )
    return report_doc, measured


def main(argv=None) -> int:
    from . import add_device_arg, tool_device, write_json

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scenario", default="diurnal_ramp",
                        help="named scenario from the workload catalog")
    parser.add_argument("--list", action="store_true",
                        help="list the scenario catalog")
    parser.add_argument("--out", default=None,
                        help="write the report's JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epilogue", type=int, default=130,
                        help="idle fleet ticks after the trace drains "
                             "(where scale-downs complete)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.list:
        return list_scenarios()
    report, measured = run_bench(args.scenario, device=tool_device(args),
                                 seed=args.seed, epilogue=args.epilogue)
    if args.out:
        write_json(args.out, report, indent=2)
        print(f"# wrote {args.out}")
    auto = measured["autoscaled"][2]
    print(f"scale events: {[(e['kind'], e['tick']) for e in auto.events]}")
    runs = report["runs"]
    print(f"burn ticks: autoscaled {runs['autoscaled']['burn_ticks']} vs "
          f"fixed {runs['fixed']['burn_ticks']}")
    print(f"gates: {report['gates']}")
    print(f"# {'PASS' if report['passed'] else 'FAIL'}")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
