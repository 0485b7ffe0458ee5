"""Flight-recorder bench: the black box's overhead and the incident
plane's gates (the port of ``tools/bench_flight.py``).

The flight recorder (``telemetry/flight.py``) promises to be cheap
enough to leave on and deterministic enough to trust in a postmortem;
the incident plane (``telemetry/incidents.py``) promises to open
incidents on real degradation and stay silent otherwise.  Four gates:

- **overhead**: the ``diurnal_ramp`` scenario replayed with the
  recorder and incident plane attached and detached (the time series
  on in both modes, so the comparison isolates the black box), the two
  modes in turns, each mode's least wall over the repeats — the
  attached run may cost at most 2% more.  Reported beside it: each
  replay's thread CPU time, the median of the repeats' attached over
  detached ratios, and the median share of an attached replay spent
  inside the recorder's tap and detector pass;
- **detection**: the ``replica_crash_storm`` and
  ``prefill_kill_mid_handoff`` chaos campaigns each open at least one
  incident whose postmortem bundle cause-chains (the chain starts at a
  ``fault`` stage and shows ``impact``);
- **silence**: the same campaigns' fault-free replays open no incident;
- **determinism**: two same-seed faulted replays give byte-identical
  deterministic flight logs and equal bundle digests.

The model is the reference bench's tiny GPT (2 blocks, hidden 64) with
random weights from ``--seed``; :func:`run_bench` takes the model
config, the weights and the overhead repeats as arguments.  Every replica sits on the one device the bench is given:
the card unless ``--device`` names another (raising on a box without
one).  The report is printed; ``--out`` writes its JSON where it says,
and nothing is written otherwise.

Usage::

    python -m skycomputing_tpu_torch.tools.bench_flight [--device cpu] \\
        [--skip-overhead] [--out PATH]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Any, Dict, Optional, Sequence

#: campaigns whose incident stories the bench gates on
CAMPAIGNS = ("replica_crash_storm", "prefill_kill_mid_handoff")

#: overhead budget: flight-attached wall over detached, least of repeats
OVERHEAD_LIMIT = 0.02
OVERHEAD_SCENARIO = "diurnal_ramp"
OVERHEAD_TICKS_SCALE = 0.5
OVERHEAD_REPEATS = 4

#: the reference bench's model and fleet (``tools/bench_flight.py``)
MODEL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=160,
             dropout_prob=0.0, dtype="float32")
ENGINE = dict(num_slots=2, max_len=128, buckets=(32, 64, 96),
              prefill_batch=1, kv_layout="paged", page_size=8)
#: wall-latency sickness parked: an EWMA of wall latency is wall-driven
#: by design, so a host pause in one of two same-seed replays would put
#: detect/drain events into one flight log only; dead-replica and
#: slot-leak detection, which the campaigns exercise, count ticks
SUPERVISOR = dict(check_every=1, heartbeat_misses=1, sick_threshold=1e9,
                  k_checks=3)


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _clocked(fn, total: list):
    """``fn``, adding its wall time to ``total[0]`` at each call."""
    def clocked(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            total[0] += time.perf_counter() - t0
    return clocked


def run_bench(
    *,
    device=None,
    seed: int = 0,
    model: Optional[Dict[str, Any]] = None,
    params: Optional[Sequence[Any]] = None,
    skip_overhead: bool = False,
    overhead_repeats: int = OVERHEAD_REPEATS,
    overhead_ticks_scale: float = OVERHEAD_TICKS_SCALE,
) -> Dict[str, Any]:
    """The bench's report: ``gates`` (name -> bool), ``passed``, the
    overhead measurement and each campaign's incidents, digests and
    gates."""
    import numpy as np

    from ..chaos import FaultInjector, get_fault_plan
    from ..disagg import DisaggFleet
    from ..fleet import FleetSupervisor, ServingFleet
    from ..models.gpt import GptConfig, gpt_layer_configs, random_state_dicts
    from ..serving import Request
    from ..telemetry.incidents import cause_chain, chain_stages
    from ..utils import resolve_device
    from ..workload import ScenarioPlayer, get_scenario
    from . import device_record

    dev = resolve_device(device)
    cfg = GptConfig(**dict(model or MODEL))
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    if params is None:
        print(f"initializing {len(layer_cfgs)}-layer GPT "
              f"(hidden={cfg.hidden_size})...", flush=True)
        params = random_state_dicts(layer_cfgs, seed)
    engine = dict(ENGINE)
    buckets = tuple(engine["buckets"])

    def make_fleet(*, replicas=2, disagg=False, flight=False):
        kw = dict(supervisor=FleetSupervisor(**SUPERVISOR),
                  devices=[dev] * max(3, replicas))
        if disagg:
            fleet = DisaggFleet(layer_cfgs, params, prefill_replicas=1,
                                decode_replicas=replicas - 1,
                                engine_kwargs=dict(engine), **kw)
        else:
            fleet = ServingFleet(layer_cfgs, params, replicas=replicas,
                                 engine_kwargs=dict(engine), **kw)
        # the time series runs in BOTH modes, so the overhead comparison
        # isolates the black box (attach_flight would enable it anyway)
        fleet.enable_timeseries()
        if flight:
            fleet.attach_flight()
        return fleet

    # one warm-up fleet serves a request per bucket before any timing
    # (the kernel libraries load and the allocator warms here)
    make_fleet().run([
        Request(prompt=np.full((b - 2,), b + 1, np.int32), max_new_tokens=2)
        for b in buckets
    ])

    gates: Dict[str, bool] = {}
    doc: Dict[str, Any] = {}
    if not skip_overhead:
        def timed_replay(flight: bool):
            """One replay's wall, its thread's CPU time, and (attached)
            the time inside the recorder's tap and detector pass."""
            fleet = make_fleet(flight=flight)
            player = ScenarioPlayer(get_scenario(
                OVERHEAD_SCENARIO, seed=seed,
                ticks_scale=overhead_ticks_scale), fleet)
            inside = [0.0]
            if flight:
                for name in ("_flight_tap", "_incident_tick"):
                    setattr(fleet, name, _clocked(getattr(fleet, name),
                                                  inside))
            # the earlier replays' fleets (engines, KV pages, reference
            # cycles) are collected here, before the window, so no
            # replay pays for another's teardown; the collector stays on
            # inside it, where the recorder's own garbage is collected
            gc.collect()
            t0, c0 = time.perf_counter(), time.thread_time()
            player.play()
            return (time.perf_counter() - t0, time.thread_time() - c0,
                    inside[0])

        runs: Dict[str, list] = {"off": [], "on": []}
        for rep in range(overhead_repeats):
            # in turns, so the host's drift falls on both modes alike
            runs["off"].append(timed_replay(False))
            runs["on"].append(timed_replay(True))
            print(f"  overhead repeat {rep}: off={runs['off'][-1][0]:.3f}s "
                  f"on={runs['on'][-1][0]:.3f}s", flush=True)
        walls = {mode: [r[0] for r in rs] for mode, rs in runs.items()}
        base, attached = min(walls["off"]), min(walls["on"])
        overhead = attached / base - 1.0
        gates["recorder_overhead"] = bool(overhead <= OVERHEAD_LIMIT)
        # reported beside the gate's reading, never in its place: each
        # repeat's two replays, back to back, as a ratio; and the share
        # of each attached replay spent inside the recorder, which the
        # host's speed moves in numerator and denominator alike
        ratios = sorted(on / off for off, on in zip(walls["off"],
                                                     walls["on"]))
        shares = sorted(r[2] / r[0] for r in runs["on"])
        doc["overhead"] = dict(
            scenario=OVERHEAD_SCENARIO, ticks_scale=overhead_ticks_scale,
            repeats=overhead_repeats, wall_s_off=walls["off"],
            wall_s_on=walls["on"], min_wall_s_off=base,
            min_wall_s_on=attached, overhead_frac=overhead,
            limit_frac=OVERHEAD_LIMIT,
            thread_cpu_s_off=[r[1] for r in runs["off"]],
            thread_cpu_s_on=[r[1] for r in runs["on"]],
            pair_ratios=ratios,
            pair_median_overhead_frac=_median(ratios) - 1.0,
            recorder_s_on=[r[2] for r in runs["on"]],
            recorder_share_median=_median(shares),
        )
        print(f"  overhead: {overhead * 100:+.2f}% "
              f"(limit {OVERHEAD_LIMIT * 100:.0f}%)", flush=True)

    def replay(plan, injector):
        fleet = make_fleet(replicas=plan.replicas, disagg=plan.disagg,
                           flight=True)
        if injector is not None:
            fleet.fault_injector = injector
        scenario = get_scenario(plan.scenario, seed=plan.scenario_seed,
                                rate_scale=plan.rate_scale,
                                ticks_scale=plan.ticks_scale)
        ScenarioPlayer(scenario, fleet).play()
        for _ in range(plan.recovery_budget_ticks + 10):
            fleet.step()
        return fleet

    results: Dict[str, Any] = {}
    for name in CAMPAIGNS:
        plan = get_fault_plan(name, seed=seed)
        t0 = time.perf_counter()
        print(f"running {name} (scenario {plan.scenario}, "
              f"{plan.replicas} replicas"
              f"{', disagg' if plan.disagg else ''})...", flush=True)
        ref = replay(plan, None)
        fleet_a = replay(plan, FaultInjector(plan))
        fleet_b = replay(plan, FaultInjector(plan))  # the same seed again

        bundles = fleet_a.bundles
        chains = [chain_stages(cause_chain(b["flight_log"]))
                  for b in bundles]
        cause_chained = [stages for stages in chains
                         if stages[:1] == ["fault"] and "impact" in stages]
        log_a = json.dumps(fleet_a.flight.deterministic_log(),
                           sort_keys=True)
        log_b = json.dumps(fleet_b.flight.deterministic_log(),
                           sort_keys=True)
        digests_a = [b["digest"] for b in fleet_a.bundles]
        digests_b = [b["digest"] for b in fleet_b.bundles]
        cgates = dict(
            incident_opened=bool(fleet_a.incidents.opened_total >= 1),
            incident_cause_chained=bool(cause_chained),
            reference_zero_incidents=bool(ref.incidents.opened_total == 0),
            deterministic_flight_log=bool(log_a == log_b),
            deterministic_bundle_digests=bool(
                digests_a == digests_b and digests_a),
        )
        gates.update({f"{name}.{g}": ok for g, ok in cgates.items()})
        wall_s = time.perf_counter() - t0
        results[name] = dict(
            plan_digest=plan.digest(),
            incidents=fleet_a.incidents.incidents_json(),
            flight=fleet_a.flight.snapshot(),
            flight_digest=fleet_a.flight.digest(),
            bundle_digests=digests_a,
            bundle_rules=[b["incident"]["rule"] for b in bundles],
            cause_chains=chains,
            reference_incidents_opened=ref.incidents.opened_total,
            gates=cgates,
            wall_s=wall_s,
        )
        failed = [g for g, ok in cgates.items() if not ok]
        print(f"  {name}: {'PASS' if not failed else 'FAIL'} "
              f"({fleet_a.incidents.opened_total} incidents, rules "
              f"{sorted(set(results[name]['bundle_rules']))}, "
              f"{wall_s:.1f}s"
              f"{'' if not failed else ', failed: ' + ', '.join(failed)})",
              flush=True)

    passed = all(gates.values())
    record = device_record(dev)
    return dict(
        bench="flight_recorder",
        device_kind=record["kind"],
        device=record,
        model=dict(cfg.to_dict()),
        fleet=dict(engine),
        seed=seed,
        notes=(
            "overhead compares the least wall over interleaved repeats "
            "with the time series on in both modes; campaign gates want "
            ">=1 cause-chained incident on faulted runs, none on the "
            "fault-free references, and byte-identical flight logs and "
            "equal bundle digests across same-seed replays; every "
            "replica on the one device"
        ),
        campaigns=results,
        gates=gates,
        passed=passed,
        **doc,
    )


def main(argv=None) -> int:
    from . import add_device_arg, tool_device, write_json

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="write the report's JSON here (default: "
                             "nowhere)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip-overhead", action="store_true",
                        help="campaign gates only")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    report = run_bench(device=tool_device(args), seed=args.seed,
                       skip_overhead=args.skip_overhead)
    if args.out:
        write_json(args.out, report, indent=2)
        print(f"wrote {args.out}")
    print(f"flight bench: {'PASS' if report['passed'] else 'FAIL'}")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
