"""Fleet benchmark and smoke: SLO-preserving degradation, measured (the
port of ``tools/bench_fleet.py``).

Two modes:

``--smoke`` (pure stdlib decision logic, no model): the router's ranking
(least-loaded, TPOT weighting, prefix affinity) and admission control
(pending bound, priority shed band, deadline rejects, Retry-After hints)
on synthetic replica snapshots.  Structural drift in either policy
fails it.

Default mode: the acceptance scenario end to end — 3 engine replicas
under steady bursty load, a seeded ``replica_crash`` of replica 0
mid-run, then a 2x admission spike against a bounded fleet.  Gates, in
the JSON written to ``--out``:

- zero committed tokens lost: every accepted request finishes and is
  token-identical to its one-shot ``generate`` reference (migrated
  requests included); a mismatch lands in ``identity_findings`` with
  its position and both tokens' reference logits;
- post-kill TTFT p95 within ``--ttft-factor`` (default 2x) of the
  pre-kill value while the replica re-forms;
- under the spike, accepted-request TPOT p95 within ``--tpot-margin``
  (default 1.25x) of the steady envelope, every rejection counted by
  reason with a Retry-After hint.

The model is the reference bench's tiny GPT (2 blocks, hidden 64) with
random weights from ``--seed``; :func:`run_scenario` takes the model
config, the engine's and the supervisor's kwargs, the SLO targets and
the phases' sizes as arguments, so a caller can drive it at another
width or layout.  Runs on the card unless ``--device`` names another
device (raising on a box without one).

Usage::

    python -m skycomputing_tpu_torch.tools.bench_fleet --smoke
    python -m skycomputing_tpu_torch.tools.bench_fleet [--device cpu] \\
        [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..fleet import admission as _admission
from ..fleet import router as _router

#: the reference bench's model (``tools/bench_fleet.py``)
MODEL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=160,
             dropout_prob=0.0, dtype="float32")
#: shared engine operating point: buckets cover prompt + max_new (59 +
#: 27), so every in-flight request stays recomputation-resumable
ENGINE = dict(num_slots=2, max_len=128, buckets=(32, 64, 96),
              prefill_batch=1)
#: detection margins sized for a noisy shared host: the degradations
#: this bench cares about are order 10x+
SUPERVISOR = dict(check_every=1, heartbeat_misses=1, sick_threshold=8.0,
                  k_checks=3)
MAX_PENDING = 12
BURST, BURST_GAP = 8, 32


def default_slo_targets():
    """The bench's two SLO targets: TTFT p95 at 2 s (should stay quiet)
    and a rejection rate sized to fire only under a real spike."""
    from ..telemetry.slo import SloTarget

    return [
        SloTarget(name="ttft_p95", metric="fleet.ttft_p95_s",
                  threshold=2.0, budget=0.25,
                  fast_window=1, slow_window=8),
        SloTarget(name="rejection_rate", metric="fleet.rejected",
                  threshold=2.0, kind="rate",
                  fast_window=1, slow_window=8),
    ]


# --------------------------------------------------------------------------
# smoke: decision logic on synthetic snapshots
# --------------------------------------------------------------------------


def run_smoke() -> int:
    problems = []

    def snap(name, healthy=True, slots=4, free=4, depth=0, tpot=None):
        return dict(name=name, healthy=healthy, slots=slots,
                    free_slots=free, queue_depth=depth, tpot_p95_s=tpot)

    router = _router.Router(affinity_slack=2.0)
    # least-loaded under skew: the idle replica wins
    ranked = router.rank([
        snap("a", depth=6, free=0), snap("b", free=1), snap("c"),
    ])
    if ranked != ["c", "b", "a"]:
        problems.append(f"skewed-load ranking {ranked}, "
                        f"expected ['c', 'b', 'a']")
    # TPOT weighting: a slower replica is more loaded at equal depth
    pick = router.choose([snap("a", free=0, tpot=0.5),
                          snap("b", free=0, tpot=0.01)])
    if pick != "b":
        problems.append(f"TPOT weighting picked {pick!r}, expected 'b'")
    # prefix affinity sticks within slack, yields beyond it
    prompt = list(range(1, 12))
    router.record_dispatch("b", prompt)
    sticky = router.choose([snap("a"), snap("b", free=2)], prompt)
    yielded = router.choose(
        [snap("a"), snap("b", free=0, depth=4)], prompt
    )
    if sticky != "b" or yielded != "a":
        problems.append(
            f"affinity sticky={sticky!r} (want 'b'), "
            f"yielded={yielded!r} (want 'a')"
        )
    if router.choose([snap("a", healthy=False)]) is not None:
        problems.append("routed to an unhealthy replica")
    print(f"# router: skew -> {ranked[0]}, affinity sticks + yields")

    adm = _admission.AdmissionController(
        max_pending=8, shed_fraction=0.5, service_s_estimate=0.1
    )
    ok = adm.decide(pending=0, capacity_slots=4)
    full = adm.decide(pending=8, capacity_slots=4)
    fuller = adm.decide(pending=16, capacity_slots=4)
    if not ok.admitted:
        problems.append("idle fleet rejected a request")
    if full.admitted or full.reason != _admission.QUEUE_FULL:
        problems.append(f"full queue decision {full}")
    if not (full.retry_after_s and fuller.retry_after_s
            and fuller.retry_after_s > full.retry_after_s > 0):
        problems.append(
            f"Retry-After hints not positive/monotone: "
            f"{full.retry_after_s} vs {fuller.retry_after_s}"
        )
    shed = adm.decide(pending=5, capacity_slots=4, priority="batch")
    keep = adm.decide(pending=5, capacity_slots=4,
                      priority="interactive")
    if shed.admitted or shed.reason != _admission.SHED_LOW_PRIORITY:
        problems.append(f"shed band did not shed batch: {shed}")
    if not keep.admitted:
        problems.append("shed band rejected interactive traffic")
    late = adm.decide(pending=3, capacity_slots=1, deadline_s=0.05)
    if late.admitted or late.reason != _admission.DEADLINE_UNMEETABLE:
        problems.append(f"unmeetable deadline admitted: {late}")
    none = adm.decide(pending=0, capacity_slots=0)
    if none.admitted or none.reason != _admission.NO_HEALTHY_REPLICA:
        problems.append(f"dead fleet admitted: {none}")
    auto = _admission.AdmissionController(queue_factor=2.0)
    if auto.pending_bound(8) != 16 or auto.pending_bound(4) != 8:
        problems.append("pending bound does not scale with capacity")
    print("# admission: bound, shed band, deadline, hints ok")

    if problems:
        for p in problems:
            print(f"bench_fleet --smoke: {p}", file=sys.stderr)
        return 1
    print("# smoke: ok")
    return 0


# --------------------------------------------------------------------------
# full mode: replica kill + spike under load
# --------------------------------------------------------------------------


def _pct(vals, q) -> Optional[float]:
    import numpy as np

    vals = [v for v in vals if v is not None]
    return float(np.percentile(vals, q)) if vals else None


def run_scenario(
    *,
    device=None,
    seed: int = 0,
    model: Optional[Dict[str, Any]] = None,
    params: Optional[Sequence[Any]] = None,
    engine_kwargs: Optional[Dict[str, Any]] = None,
    supervisor_kwargs: Optional[Dict[str, Any]] = None,
    router=None,
    slo_targets=None,
    n_bursts: int = 7,
    n_spike: int = 32,
    ttft_factor: float = 2.0,
    tpot_margin: float = 1.25,
    timeseries_clock: Optional[Callable[[], float]] = None,
    setup: Optional[Callable[[Any], None]] = None,
    on_tick: Optional[Callable[[Any], None]] = None,
):
    """The kill-and-spike scenario over 3 replicas; returns ``(report,
    fleet, accepted)``.

    ``model`` (a ``GptConfig`` dict, default :data:`MODEL`) is built
    with ``params`` (per-layer state dicts) or random weights from
    ``seed``.  ``engine_kwargs`` default to :data:`ENGINE` and
    ``supervisor_kwargs`` to :data:`SUPERVISOR`; ``slo_targets`` to
    :func:`default_slo_targets`.  ``setup(fleet)`` runs once before the
    warmup, ``on_tick(fleet)`` after every measured ``fleet.step()``;
    ``timeseries_clock`` replaces the time series' wall clock (the SLO
    rate target's seconds)."""
    import numpy as np

    from ..bench_serving import _identical, _one_shot
    from ..dynamics import FaultPlan, FleetFaultInjector
    from ..fleet import AdmissionController, FleetSupervisor, ServingFleet
    from ..models.gpt import GptConfig, gpt_layer_configs, random_state_dicts
    from ..serving import Request
    from ..telemetry.slo import SloMonitor
    from ..utils import resolve_device
    from ..workload import mixes

    dev = resolve_device(device)
    cfg = GptConfig(**dict(model or MODEL))
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    if params is None:
        print(f"initializing {len(layer_cfgs)}-layer GPT "
              f"(hidden={cfg.hidden_size})...", flush=True)
        params = random_state_dicts(layer_cfgs, seed)
    engine = dict(ENGINE if engine_kwargs is None else engine_kwargs)
    # the request mixes come from the workload plane by name; their
    # draws are the reference bench's at equal seed
    rng = np.random.default_rng(seed)
    replicas = 3
    fleet = ServingFleet(
        layer_cfgs, params, replicas=replicas,
        engine_kwargs=engine,
        admission=AdmissionController(max_pending=MAX_PENDING),
        supervisor=FleetSupervisor(**dict(
            SUPERVISOR if supervisor_kwargs is None
            else supervisor_kwargs)),
        router=router,
        devices=[dev] * replicas,
    )
    # live observability riding along: a per-tick time series and an
    # online SLO monitor whose verdicts land in the report; while the
    # rejection-rate target burns, the admission bound tightens
    ts_kw = {} if timeseries_clock is None else dict(clock=timeseries_clock)
    fleet.enable_timeseries(window=4096, **ts_kw)
    slo = fleet.attach_slo(SloMonitor(
        list(slo_targets) if slo_targets is not None
        else default_slo_targets()))
    if setup is not None:
        setup(fleet)

    # warmup: one request per bucket per replica, outside the window
    buckets = tuple(engine.get("buckets", ENGINE["buckets"]))
    warm = []
    for _ in range(replicas):
        for b in buckets:
            r = Request(
                prompt=rng.integers(1, 500, (b - 2,)).astype(np.int32),
                max_new_tokens=2,
            )
            warm.append(r)
            fleet.submit(r)
    fleet.run()
    print(f"warmup done ({len(warm)} requests, "
          f"{fleet.stats.reforms} reforms)", flush=True)

    # phase A+B: steady bursty load (bursts of 8 every 32 ticks against
    # 6 slots x ~22-tick generations): the tail of each burst waits for
    # slots and the queue drains before the next.  Replica 0 dies
    # mid-window; the first burst is ramp-in, left out of the pre-kill
    # statistics
    n_steady = BURST * n_bursts
    ramp_in = BURST
    kill_after = BURST_GAP * (n_bursts // 2) + BURST_GAP // 2
    tick0 = fleet.tick
    kill_abs = tick0 + kill_after
    fleet.fault_injector = FleetFaultInjector(FaultPlan(
        [dict(iter=kill_abs, kind="replica_crash", replica=0)],
        seed=seed,
    ))
    arrivals = [
        (tick, Request(prompt=prompt, max_new_tokens=n))
        for tick, (prompt, n) in mixes.fleet_bursty_arrivals(
            rng, n=n_steady, burst=BURST, gap=BURST_GAP, start=tick0,
        )
    ]
    t_start = time.perf_counter()
    steady_log: list = []  # (request, arrival_tick, decision)
    i = 0
    while i < len(arrivals) or fleet.has_work():
        while i < len(arrivals) and arrivals[i][0] <= fleet.tick:
            tick, request = arrivals[i]
            steady_log.append((request, tick, fleet.submit(request)))
            i += 1
        fleet.step()
        if on_tick is not None:
            on_tick(fleet)
    steady = [r for r, _, d in steady_log if d.admitted]
    steady_shed = [d for _, _, d in steady_log if not d.admitted]
    pre = [r for r, t, d in steady_log[ramp_in:]
           if d.admitted and t < kill_abs]
    post = [r for r, t, d in steady_log if d.admitted and t >= kill_abs]
    pre_ttft = _pct([r.ttft_s() for r in pre], 95)
    post_ttft = _pct([r.ttft_s() for r in post], 95)
    steady_tpot = _pct([r.tpot_s() for r in steady], 95)

    # phase C: 2x arrival rate against the bounded admission
    rejected_before = dict(fleet.stats.rejected_by_reason)
    spike_requests = [
        Request(prompt=prompt, max_new_tokens=n)
        for prompt, n in mixes.fleet_spike_specs(rng, n=n_spike)
    ]
    spike_decisions = []
    j = 0
    while j < len(spike_requests) or fleet.has_work():
        burst = 0
        while j < len(spike_requests) and burst < 2:  # 2/tick = 2x rate
            spike_decisions.append(fleet.submit(spike_requests[j]))
            j += 1
            burst += 1
        fleet.step()
        if on_tick is not None:
            on_tick(fleet)
    wall_s = time.perf_counter() - t_start
    spike_accepted = [
        r for r, d in zip(spike_requests, spike_decisions) if d.admitted
    ]
    spike_rejected = [d for d in spike_decisions if not d.admitted]
    spike_tpot = _pct([r.tpot_s() for r in spike_accepted], 95)

    # gates: every accepted request finished, token-identical to its
    # one-shot reference (a mismatch's position and logits in findings)
    accepted = steady + spike_accepted
    finished_all = all(r.status == "finished" for r in accepted)
    findings: List[dict] = []
    identical = finished_all and _identical(
        {r.request_id: r.output() for r in accepted}, accepted,
        _one_shot(layer_cfgs, params, dev, cfg.max_position_embeddings),
        findings)
    zero_lost = finished_all and fleet.stats.failed == 0 and identical
    ttft_ok = (pre_ttft is not None and post_ttft is not None
               and post_ttft <= ttft_factor * pre_ttft)
    tpot_ok = (steady_tpot is not None and spike_tpot is not None
               and spike_tpot <= tpot_margin * steady_tpot)
    shed_visible = (
        len(spike_rejected) > 0
        and all(d.retry_after_s and d.retry_after_s > 0
                for d in spike_rejected)
        and fleet.stats.rejected
        == sum(fleet.stats.rejected_by_reason.values())
    )
    reformed = fleet.stats.reforms >= 1
    generated = sum(len(r.tokens) for r in accepted)

    from . import device_record

    report = dict(
        bench="fleet_kill_and_spike",
        device=device_record(dev),
        model=dict(cfg.to_dict()),
        fleet=dict(replicas=replicas,
                   slots_per_replica=engine.get("num_slots"),
                   max_len=engine.get("max_len"),
                   buckets=list(buckets), max_pending=MAX_PENDING,
                   kv_layout=engine.get("kv_layout", "slot"),
                   kill_tick=kill_abs, seed=seed),
        steady=dict(
            requests=len(steady),
            shed=len(steady_shed),
            pre_kill=len(pre), post_kill=len(post),
            ttft_p95_pre_kill_s=pre_ttft,
            ttft_p95_post_kill_s=post_ttft,
            ttft_degradation=(post_ttft / pre_ttft
                              if pre_ttft and post_ttft else None),
            tpot_p95_s=steady_tpot,
        ),
        spike=dict(
            submitted=len(spike_requests),
            accepted=len(spike_accepted),
            rejected=len(spike_rejected),
            rejected_by_reason={
                k: v - rejected_before.get(k, 0)
                for k, v in fleet.stats.rejected_by_reason.items()
                if v - rejected_before.get(k, 0) > 0
            },
            tpot_p95_s=spike_tpot,
            tpot_vs_envelope=(spike_tpot / steady_tpot
                              if steady_tpot and spike_tpot else None),
        ),
        wall_s=wall_s,
        generated_tokens=generated,
        tokens_per_s=generated / wall_s if wall_s > 0 else None,
        fleet_stats=fleet.stats.snapshot(),
        supervisor_events=[dict(e) for e in fleet.supervisor.events],
        timeseries=fleet.timeseries.summary(keys=[
            "fleet.submitted", "fleet.admitted", "fleet.rejected",
            "fleet.migrations", "fleet.pending",
            "fleet.replicas_healthy", "fleet.ttft_p95_s",
            "fleet.tpot_p95_s",
        ], points=48),
        slo=dict(
            targets=[dict(name=t.name, metric=t.metric,
                          threshold=t.threshold, kind=t.kind,
                          mode=t.mode, budget=t.budget,
                          fast_window=t.fast_window,
                          slow_window=t.slow_window)
                     for t in slo.targets],
            verdicts=[a.to_dict() for a in slo.last_alerts()],
            fired_ever=sorted(slo.fired_ever),
            alerts_total=slo.alerts_total,
            evaluations=slo.evaluations,
        ),
        identity_findings=findings,
        gates=dict(
            zero_lost_tokens=bool(zero_lost),
            token_identical=bool(identical),
            replica_reformed=bool(reformed),
            ttft_within_factor=bool(ttft_ok),
            ttft_factor=ttft_factor,
            tpot_within_envelope=bool(tpot_ok),
            tpot_margin=tpot_margin,
            shedding_visible=bool(shed_visible),
        ),
    )
    report["passed"] = all(
        v for k, v in report["gates"].items() if isinstance(v, bool)
    )
    return report, fleet, accepted


def _print_summary(report) -> None:
    def fmt(v, scale=1.0, unit="s"):
        # degenerate phases (no samples) print as n/a
        return "n/a" if v is None else f"{v * scale:.3f}{unit}"

    def ratio(a, b):
        return "n/a" if not a or not b else f"{a / b:.2f}x"

    st, sp, fs = report["steady"], report["spike"], report["fleet_stats"]
    print(f"steady: ttft_p95 pre {fmt(st['ttft_p95_pre_kill_s'])} -> post "
          f"{fmt(st['ttft_p95_post_kill_s'])} "
          f"({ratio(st['ttft_p95_post_kill_s'], st['ttft_p95_pre_kill_s'])})"
          f", migrations={fs['migrations']}, reforms={fs['reforms']}",
          flush=True)
    print(f"spike: {sp['accepted']} accepted / {sp['rejected']} shed, "
          f"tpot_p95 {fmt(st['tpot_p95_s'], 1e3, 'ms')} -> "
          f"{fmt(sp['tpot_p95_s'], 1e3, 'ms')} "
          f"({ratio(sp['tpot_p95_s'], st['tpot_p95_s'])} envelope)",
          flush=True)
    print(f"slo: fired={report['slo']['fired_ever']} "
          f"(alerts={report['slo']['alerts_total']}, "
          f"evaluations={report['slo']['evaluations']})", flush=True)
    print(f"gates: {report['gates']}")
    print(f"# {'PASS' if report['passed'] else 'FAIL'}")


def run_bench(out: Optional[str], seed: int, ttft_factor: float,
              tpot_margin: float, device=None) -> int:
    from . import write_json

    report, _, _ = run_scenario(device=device, seed=seed,
                                ttft_factor=ttft_factor,
                                tpot_margin=tpot_margin)
    if out:
        write_json(out, report, indent=2)
        print(f"# wrote {out}")
    _print_summary(report)
    return 0 if report["passed"] else 1


def main(argv=None) -> int:
    from . import add_device_arg, tool_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--smoke", action="store_true",
                        help="router + admission decision-logic check "
                             "(pure stdlib)")
    parser.add_argument("--out", default="build/bench_fleet.json",
                        help="the report's JSON (full mode)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ttft-factor", type=float, default=2.0,
                        help="post-kill TTFT p95 budget vs pre-kill")
    parser.add_argument("--tpot-margin", type=float, default=1.25,
                        help="spike TPOT p95 budget vs steady envelope")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.smoke:
        return run_smoke()
    return run_bench(args.out, args.seed, args.ttft_factor,
                     args.tpot_margin, device=tool_device(args))


if __name__ == "__main__":
    sys.exit(main())
