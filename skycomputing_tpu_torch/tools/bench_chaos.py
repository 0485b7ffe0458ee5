"""Chaos bench: named fault campaigns replayed and audited, gated (the
port of ``tools/bench_chaos.py``).

Every catalog plan runs through the same harness:

- **reference**: the plan's paired scenario on a fault-free fleet of the
  plan's shape, the token-identity baseline;
- **faulted**: the same trace with the plan's :class:`FaultInjector`
  attached, then an idle epilogue of ``recovery_budget_ticks + 10`` so
  recovery lands inside the replay;
- **faulted, again**: the same seed end to end, the determinism run.

A disaggregated plan runs one prefill specialist and ``replicas - 1``
decoders, so its ``index:0`` selector names the prefill side; an
autoscaled plan runs the autoscaler under a queue-pressure SLO target.
The reference bench gives each replica a device of its own; here every
replica sits on the one device the bench is given.

Gates, per plan, in the JSON written to ``--out``:

- the whole-run audit (:func:`~..chaos.invariants.audit_run`) passes:
  zero lost or duplicated tokens, every terminal state reasoned,
  streams token-identical to the fault-free reference, page and slot
  consistency on every live engine, monotonic counters, the handoff
  ledger conserved, and time-to-healthy within the plan's
  ``recovery_budget_ticks``;
- both replays saw the same trace (digest equality);
- at least one fault applied;
- the two same-seed faulted runs gave the same deterministic event log
  and equal audit digests.

The model is the reference bench's tiny GPT (2 blocks, hidden 64) with
random weights from ``--seed``; :func:`run_bench` takes the model
config, the weights, the engine's and the supervisor's kwargs as
arguments.  Runs on the card unless ``--device`` names another device
(raising on a box without one); ``--list`` needs no device.

Usage::

    python -m skycomputing_tpu_torch.tools.bench_chaos --list
    python -m skycomputing_tpu_torch.tools.bench_chaos [--device cpu] \\
        [--plan NAME] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

from ..chaos import plan as catalog

#: the reference bench's model (``tools/bench_chaos.py``)
MODEL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=160,
             dropout_prob=0.0, dtype="float32")
ENGINE = dict(num_slots=2, max_len=128, buckets=(32, 64, 96),
              prefill_batch=1, kv_layout="paged", page_size=8)
SUPERVISOR = dict(check_every=1, heartbeat_misses=1, sick_threshold=8.0,
                  k_checks=3)


def list_plans() -> int:
    for name in catalog.fault_plan_names():
        p = catalog.get_fault_plan(name)
        print(f"{name:20s} events={len(p.events):2d} "
              f"scenario={p.scenario:18s} replicas={p.replicas} "
              f"budget={p.recovery_budget_ticks:3d}t  {p.description}")
    return 0


def run_bench(
    plan_names: Sequence[str],
    *,
    device=None,
    seed: int = 0,
    model: Optional[Dict[str, Any]] = None,
    params: Optional[Sequence[Any]] = None,
    engine_kwargs: Optional[Dict[str, Any]] = None,
    supervisor_kwargs: Optional[Dict[str, Any]] = None,
    router_factory: Optional[Callable[[], Any]] = None,
):
    """Each named plan's three replays; returns ``(report, runs)`` with
    ``runs[name]`` the ``(fleet, player report, injector, audit)`` of
    the faulted run and of the determinism run, and the reference's
    ``(fleet, player report)``.

    ``model`` (a ``GptConfig`` dict, default :data:`MODEL`) is built
    with ``params`` or random weights from ``seed``; ``engine_kwargs``
    default to :data:`ENGINE`, ``supervisor_kwargs`` to
    :data:`SUPERVISOR`; ``router_factory()`` makes each fleet's router."""
    import numpy as np

    from ..chaos import FaultInjector, audit_run, get_fault_plan, make_probe
    from ..disagg import DisaggFleet
    from ..fleet import FleetAutoscaler, FleetSupervisor, ServingFleet
    from ..models.gpt import GptConfig, gpt_layer_configs, random_state_dicts
    from ..serving import Request
    from ..telemetry.slo import SloMonitor, SloTarget
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
    engine = dict(ENGINE if engine_kwargs is None else engine_kwargs)
    sup_kw = dict(SUPERVISOR if supervisor_kwargs is None
                  else supervisor_kwargs)
    buckets = tuple(engine["buckets"])

    def make_fleet(plan):
        auto = None
        if plan.autoscale:
            auto = FleetAutoscaler(
                min_replicas=1, max_replicas=max(3, plan.replicas),
                up_streak=3, down_streak=6, cooldown_ticks=8,
                slack_utilization=0.35)
        kw = dict(supervisor=FleetSupervisor(**sup_kw), autoscaler=auto,
                  devices=[dev] * max(3, plan.replicas))
        if router_factory is not None:
            kw["router"] = router_factory()
        if plan.disagg:
            fleet = DisaggFleet(layer_cfgs, params, prefill_replicas=1,
                                decode_replicas=plan.replicas - 1,
                                engine_kwargs=dict(engine), **kw)
        else:
            fleet = ServingFleet(layer_cfgs, params,
                                 replicas=plan.replicas,
                                 engine_kwargs=dict(engine), **kw)
        if auto is not None:
            # the autoscaler's burn signal: without a monitor it could
            # only ever scale down
            fleet.attach_slo(SloMonitor([
                SloTarget(name="queue_pressure", metric="fleet.queue_depth",
                          threshold=2, budget=0.25, fast_window=1,
                          slow_window=8)]))
        return fleet

    # one warm-up fleet serves a request per bucket before any replay
    warm_fleet = make_fleet(get_fault_plan(plan_names[0], seed=seed))
    warm_fleet.run([Request(prompt=np.full((b - 2,), b + 1, np.int32),
                            max_new_tokens=2) for b in buckets])
    del warm_fleet

    def replay(plan, scenario, injector):
        fleet = make_fleet(plan)
        if injector is not None:
            fleet.fault_injector = injector
        probe = make_probe(fleet)
        report = ScenarioPlayer(scenario, fleet, sample_fn=probe).play()
        # idle epilogue: recovery (and autoscaler drains) land inside
        # the replay
        for _ in range(plan.recovery_budget_ticks + 10):
            fleet.step()
            report.timeline.append(probe())
        return fleet, report

    plans, runs, all_passed = {}, {}, True
    for name in plan_names:
        plan = get_fault_plan(name, seed=seed)
        t0 = time.perf_counter()
        print(f"running {name} (scenario {plan.scenario}, "
              f"{plan.replicas} replicas"
              f"{', autoscaled' if plan.autoscale else ''})...", flush=True)

        def trace():
            return get_scenario(plan.scenario, seed=plan.scenario_seed,
                                rate_scale=plan.rate_scale,
                                ticks_scale=plan.ticks_scale)

        ref_fleet, ref_report = replay(plan, trace(), None)
        inj_a = FaultInjector(plan)
        fleet_a, rep_a = replay(plan, trace(), inj_a)
        audit_a = audit_run(fleet_a, rep_a, reference=ref_report,
                            injector=inj_a)
        inj_b = FaultInjector(plan)
        fleet_b, rep_b = replay(plan, trace(), inj_b)
        audit_b = audit_run(fleet_b, rep_b, reference=ref_report,
                            injector=inj_b)

        applied = [e for e in inj_a.event_log() if e["ok"]]
        gates = {c.name: bool(c.ok) for c in audit_a.checks}
        gates.update(
            workload_replayable=bool(rep_a.digest == ref_report.digest),
            faults_applied=bool(applied),
            event_log_deterministic=bool(
                inj_a.deterministic_log() == inj_b.deterministic_log()
                and audit_a.digest() == audit_b.digest()),
        )
        passed = all(gates.values())
        all_passed = all_passed and passed
        wall_s = time.perf_counter() - t0
        plans[name] = dict(
            plan=plan.to_dict(),
            plan_digest=plan.digest(),
            trace_digest=rep_a.digest,
            summary=rep_a.summary(),
            reference_summary=ref_report.summary(),
            event_log=inj_a.event_log(),
            recoveries=list(inj_a.recoveries),
            audit=audit_a.to_dict(),
            audit_digest=audit_a.digest(),
            fleet_stats=fleet_a.stats.snapshot(),
            quarantined={n: dict(q) for n, q in
                         fleet_a.supervisor.quarantined.items()},
            gates=gates,
            passed=passed,
            wall_s=wall_s,
        )
        runs[name] = dict(reference=(ref_fleet, ref_report),
                          faulted=(fleet_a, rep_a, inj_a, audit_a),
                          again=(fleet_b, rep_b, inj_b, audit_b))
        failed = [g for g, ok in gates.items() if not ok]
        print(f"  {name}: {'PASS' if passed else 'FAIL'} "
              f"({len(applied)}/{len(inj_a.event_log())} events applied, "
              f"{plans[name]['summary']['total']['finished']} finished, "
              f"{wall_s:.1f}s"
              f"{'' if passed else ', failed: ' + ', '.join(failed)})",
              flush=True)

    record = device_record(dev)
    report_doc = dict(
        bench="chaos_fault_plans",
        device_kind=record["kind"],
        device=record,
        model=dict(cfg.to_dict()),
        fleet=dict(engine),
        seed=seed,
        notes=(
            "each plan replays its paired scenario three times: a "
            "fault-free reference, the faulted run the audit judges, and "
            "a same-seed determinism run whose event log and audit "
            "digest must match; every replica on the one device"
        ),
        plans=plans,
        passed=all_passed,
    )
    return report_doc, runs


def main(argv=None) -> int:
    from . import add_device_arg, tool_device, write_json

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--list", action="store_true",
                        help="list the fault-plan catalog and exit")
    parser.add_argument("--plan", default=None,
                        help="run one named plan (default: the whole "
                             "catalog)")
    parser.add_argument("--out", default=None,
                        help="write the report's JSON here")
    parser.add_argument("--seed", type=int, default=0)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.list:
        return list_plans()
    names = [args.plan] if args.plan else catalog.fault_plan_names()
    for name in names:
        if name not in catalog.fault_plan_names():
            raise SystemExit(f"unknown fault plan {name!r}; catalog: "
                             f"{catalog.fault_plan_names()}")
    report, _ = run_bench(names, device=tool_device(args), seed=args.seed)
    if args.out:
        write_json(args.out, report, indent=2)
        print(f"wrote {args.out}")
    print(f"chaos bench: {'PASS' if report['passed'] else 'FAIL'}")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
