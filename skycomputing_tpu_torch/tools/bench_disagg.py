"""Disaggregation bench: prefill/decode pools against a monolithic fleet
(the port of ``tools/bench_disagg.py``).

The acceptance scenario is ``disagg_mix`` (an ingest wave of long
prompts and short answers, a mixed middle, a chat stream of short
prompts and long answers) replayed at equal replica counts:

- **monolithic**: ``ServingFleet`` with 4 replicas on one operating
  point, every replica both prefilling and decoding;
- **disagg**: ``DisaggFleet`` with 3 prefill specialists (the same
  operating point; their rows turn over at the first token, when the
  request exports as a checksummed handoff) and 1 decode specialist on a
  deep slot ledger (``num_slots=4``, 128 pages) that verifies the
  record's checksum first, then seats its pages through the engine's
  swap-in.

The reference bench gives each replica a device of its own; here every
replica sits on the one device the bench is given.

Method: latency-threshold supervision is parked out of reach (a
wall-clock sickness probe would drain a replica into a latency
measurement), the garbage collector is paused during measured replays,
and each topology is replayed ``replays`` times, interleaved, the
latency gates comparing the minimum of the per-replay p95s.  A
throwaway replay of each topology runs first (``throwaway``), and each
fleet serves one warm-up request per bucket before its replay.
``steady_state_compiles`` counts kernel-library loads
(``ops/_build.load.count``) in a measured replay: PyTorch runs eagerly
and the engine compiles nothing.

Gates, in the JSON written to ``--out``:

- ``ttft_p95`` AND ``tpot_p95`` both improve at equal replica counts;
- zero lost tokens in both topologies, every stream token-identical to
  the one-shot ``generate`` (a mismatch lands in ``identity_findings``
  with its position and both tokens' reference logits), and the disagg
  streams equal the monolith's request for request;
- zero steady-state kernel-library loads in both topologies;
- every finished disagg request crossed the handoff plane exactly once
  and the ledger conserves every record, nothing stranded;
- every run saw the same arrival trace (digest equality), and the
  disagg replays are digest-equal, token-identical and ledger-identical.

Beside the gates: tokens/s of each replay, the exported records' host
bytes as each record states them, and the seconds a record spends in
``export_handoff`` (the device-to-host gather and its checksum) and in
``import_handoff`` (the checksum verified again; the pages' scatter to
the decode engine's device happens at its next admission, inside its
tick).

The model is the reference bench's tiny GPT (2 blocks, hidden 64) with
random weights from ``--seed``; :func:`run_bench` takes the model
config, the weights, both pools' engine kwargs and the supervisor's as
arguments.  Runs on the card unless ``--device`` names another device
(raising on a box without one).

Usage::

    python -m skycomputing_tpu_torch.tools.bench_disagg [--device cpu] \\
        [--out PATH] [--rate-scale 2.5]
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

#: the reference bench's model (``tools/bench_disagg.py``)
MODEL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=160,
             dropout_prob=0.0, dtype="float32")
#: both pools' operating point: paged KV so handoffs are page-aligned,
#: the page geometry equal in both pools (the record's contract)
ENGINE = dict(num_slots=2, max_len=128, buckets=(32, 64, 96),
              prefill_batch=1, kv_layout="paged", page_size=8)
#: the decode specialist's deep slot ledger
DECODE = dict(num_slots=4, num_pages=128)
#: heartbeat and crash supervision on, the latency threshold parked
SUPERVISOR = dict(check_every=1, heartbeat_misses=1, sick_threshold=1e9,
                  k_checks=3)
MONO_REPLICAS = 4
PREFILL_REPLICAS = 3
DECODE_REPLICAS = 1
REPLAYS = 4
MODES = ("monolithic", "disagg")
HANDOFF_KEYS = ("handoffs_out", "handoffs_in", "handoff_failures",
                "handoff_bytes")


def _time_handoffs(fleet, clock: Dict[str, list]) -> None:
    """Time each engine's ``export_handoff`` and ``import_handoff`` into
    ``clock["export"]`` / ``clock["import"]``, and each exported record's
    host bytes (its ``nbytes``, stamped at swap-out) into
    ``clock["export_bytes"]`` (wrappers on the engine instances; the
    methods themselves are unchanged)."""
    for replica in fleet.replicas:
        engine = replica.engine
        for name, key in (("export_handoff", "export"),
                          ("import_handoff", "import")):
            method = getattr(engine, name)

            def timed(*args, _method=method, _key=key, **kw):
                t0 = time.perf_counter()
                out = _method(*args, **kw)
                clock[_key].append(time.perf_counter() - t0)
                if _key == "export":
                    clock["export_bytes"].append(out[1]["nbytes"])
                return out

            setattr(engine, name, timed)


def _mean(xs) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def run_bench(
    *,
    device=None,
    seed: int = 0,
    rate_scale: float = 2.5,
    epilogue: int = 60,
    replays: int = REPLAYS,
    throwaway: bool = True,
    model: Optional[Dict[str, Any]] = None,
    params: Optional[Sequence[Any]] = None,
    engine_kwargs: Optional[Dict[str, Any]] = None,
    decode_kwargs: Optional[Dict[str, Any]] = None,
    supervisor_kwargs: Optional[Dict[str, Any]] = None,
    setup: Optional[Callable[[Any, str], None]] = None,
):
    """Both topologies over ``disagg_mix``; returns ``(report,
    replays)`` with ``replays[mode]`` the measured ``(fleet, player
    report)`` pairs.

    ``model`` (a ``GptConfig`` dict, default :data:`MODEL`) is built
    with ``params`` (per-layer state dicts) or random weights from
    ``seed``.  ``engine_kwargs`` default to :data:`ENGINE`,
    ``decode_kwargs`` (the decode pool's overrides) to :data:`DECODE`,
    ``supervisor_kwargs`` to :data:`SUPERVISOR`.  ``setup(fleet, mode)``
    runs after a measured fleet's warm-up, before its replay."""
    import numpy as np

    from ..bench_serving import _identical, _one_shot
    from ..disagg import DisaggFleet
    from ..fleet import FleetSupervisor, ServingFleet
    from ..models.gpt import GptConfig, gpt_layer_configs, random_state_dicts
    from ..ops import _build
    from ..serving import Request
    from ..utils import resolve_device
    from ..workload import ScenarioPlayer, get_scenario
    from . import device_record

    dev = resolve_device(device)
    scenario = get_scenario("disagg_mix", seed=seed, rate_scale=rate_scale)
    cfg = GptConfig(**dict(model or MODEL))
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    if params is None:
        print(f"initializing {len(layer_cfgs)}-layer GPT "
              f"(hidden={cfg.hidden_size})...", flush=True)
        params = random_state_dicts(layer_cfgs, seed)
    engine = dict(ENGINE if engine_kwargs is None else engine_kwargs)
    decode = dict(DECODE if decode_kwargs is None else decode_kwargs)
    sup_kw = dict(SUPERVISOR if supervisor_kwargs is None
                  else supervisor_kwargs)
    buckets = tuple(engine["buckets"])
    worst = scenario.max_prompt_len + scenario.max_new_tokens
    if scenario.max_prompt_len > max(buckets) or worst > engine["max_len"]:
        raise SystemExit(
            f"scenario {scenario.name} needs prompt<={max(buckets)} and "
            f"{worst} positions but the bench engine tops out at "
            f"{engine['max_len']}")

    def make_fleet(mode):
        kw = dict(supervisor=FleetSupervisor(**sup_kw))
        if mode == "monolithic":
            return ServingFleet(layer_cfgs, params, replicas=MONO_REPLICAS,
                                engine_kwargs=dict(engine),
                                devices=[dev] * MONO_REPLICAS, **kw)
        return DisaggFleet(layer_cfgs, params,
                           prefill_replicas=PREFILL_REPLICAS,
                           decode_replicas=DECODE_REPLICAS,
                           engine_kwargs=dict(engine),
                           decode_kwargs=dict(decode),
                           devices=[dev] * (PREFILL_REPLICAS
                                            + DECODE_REPLICAS), **kw)

    def warm(fleet):
        """One request per bucket and replica's worth, then the SLO
        windows reset: measured replays start from served engines."""
        fleet.run([Request(prompt=np.full((b - 2,), b + 1, np.int32),
                           max_new_tokens=2)
                   for b in buckets for _ in range(2)])
        fleet.reset_slo_windows()

    def play(fleet):
        def probe():
            return dict(tick=fleet.tick,
                        healthy=len(fleet.healthy_replicas),
                        pending=fleet.stats.pending)

        player = ScenarioPlayer(scenario, fleet, sample_fn=probe)
        loads0 = _build.load.count
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        try:
            report = player.play()
            # idle epilogue: in-flight handoffs deliver and decode rows
            # drain inside the replay
            for _ in range(int(epilogue)):
                fleet.step()
                report.timeline.append(probe())
        finally:
            gc.enable()
        report.wall_s = time.perf_counter() - t0
        return report, _build.load.count - loads0

    def handoff_counters(fleet):
        total = dict.fromkeys(HANDOFF_KEYS, 0)
        for rep in fleet.replicas:
            if rep.engine is not None:
                for k in HANDOFF_KEYS:
                    total[k] += getattr(rep.engine.stats, k)
        return total

    def streams(report):
        return [v.request.output().tolist() for v in report.finished]

    if throwaway:
        print("throwaway replays (one per topology)...", flush=True)
        for mode in MODES:
            fleet = make_fleet(mode)
            warm(fleet)
            play(fleet)

    # measured replays, interleaved so both topologies sample the same
    # stretches of host noise
    measured = {mode: [] for mode in MODES}
    for i in range(int(replays)):
        for mode in MODES:
            fleet = make_fleet(mode)
            warm(fleet)
            clock = {"export": [], "import": [], "export_bytes": []}
            _time_handoffs(fleet, clock)
            if setup is not None:
                setup(fleet, mode)
            print(f"running {scenario.name} [{mode} {i + 1}/{replays}]...",
                  flush=True)
            report, loads = play(fleet)
            measured[mode].append((fleet, report, loads, clock))

    runs = {}
    for mode in MODES:
        per_run = []
        for fleet, report, loads, clock in measured[mode]:
            total = report.summary()["total"]
            generated = sum(len(v.request.tokens) for v in report.finished)
            per_run.append(dict(
                summary_total=total,
                wall_s=report.wall_s,
                generated_tokens=generated,
                tokens_per_s=(generated / report.wall_s
                              if report.wall_s > 0 else None),
                steady_state_compiles=loads,
                export_s_per_record=_mean(clock["export"]),
                import_s_per_record=_mean(clock["import"]),
                exported_records=len(clock["export_bytes"]),
                exported_record_bytes=sum(clock["export_bytes"]),
            ))
        fleet = measured[mode][0][0]
        doc = dict(
            replays=per_run,
            ttft_p95_s_floor=min(r["summary_total"]["ttft_p95_s"]
                                 for r in per_run),
            tpot_p95_s_floor=min(r["summary_total"]["tpot_p95_s"]
                                 for r in per_run),
            fleet_stats=fleet.stats.snapshot(),
            handoff_counters=handoff_counters(fleet),
        )
        if mode == "disagg":
            doc["ledger"] = fleet.ledger.audit()
        runs[mode] = doc
        t = per_run[0]["summary_total"]
        print(f"  {mode}: finished {t['finished']}/{t['arrivals']}, "
              f"ttft_p95 floor {doc['ttft_p95_s_floor']:.4f}s, "
              f"tpot_p95 floor {doc['tpot_p95_s_floor']:.4f}s", flush=True)

    one_shot = _one_shot(layer_cfgs, params, dev,
                         cfg.max_position_embeddings)
    findings: list = []

    def identity_ok(report) -> bool:
        reqs = [v.request for v in report.finished]
        return _identical({r.request_id: r.output() for r in reqs}, reqs,
                          one_shot, findings)

    mono_fleet, mono_rep = measured["monolithic"][0][:2]
    dis_fleet, dis_rep = measured["disagg"][0][:2]
    ledger = runs["disagg"]["ledger"]
    zero_lost = all(
        len(report.finished) == len(report.admitted)
        and fleet.stats.failed == 0
        for mode in MODES for fleet, report, _, _ in measured[mode])
    # zero rejections: both admitted lists follow the trace's order, so
    # stream k in one topology is stream k in the other
    cross_identical = (mono_fleet.stats.rejected == 0
                       and dis_fleet.stats.rejected == 0
                       and streams(mono_rep) == streams(dis_rep))
    dis_runs = measured["disagg"]
    gates = dict(
        ttft_p95_improved=bool(runs["disagg"]["ttft_p95_s_floor"]
                               < runs["monolithic"]["ttft_p95_s_floor"]),
        tpot_p95_improved=bool(runs["disagg"]["tpot_p95_s_floor"]
                               < runs["monolithic"]["tpot_p95_s_floor"]),
        zero_lost_tokens=bool(zero_lost),
        token_identical=bool(identity_ok(mono_rep)
                             and identity_ok(dis_rep)
                             and cross_identical),
        zero_steady_state_recompiles=bool(all(
            r["steady_state_compiles"] == 0
            for mode in MODES for r in runs[mode]["replays"])),
        every_request_handed_off=bool(
            ledger["delivered_total"] == len(dis_rep.finished)
            and ledger["failed_total"] == 0),
        ledger_conserved=bool(ledger["conservation_ok"]
                              and ledger["pending"] == 0),
        workload_replayable=bool(mono_rep.digest == dis_rep.digest),
        replay_deterministic=bool(
            all(r.digest == dis_rep.digest for _, r, _, _ in dis_runs)
            and all(streams(r) == streams(dis_rep)
                    for _, r, _, _ in dis_runs)
            and all(f.ledger.audit() == ledger for f, _, _, _ in dis_runs)),
    )
    passed = all(gates.values())
    record = device_record(dev)
    report_doc = dict(
        bench="disagg_vs_monolithic",
        device_kind=record["kind"],
        device=record,
        model=dict(cfg.to_dict()),
        fleet=dict(
            chips_per_side=MONO_REPLICAS,
            monolithic=dict(replicas=MONO_REPLICAS),
            disagg=dict(prefill_replicas=PREFILL_REPLICAS,
                        decode_replicas=DECODE_REPLICAS,
                        decode_kwargs=decode),
            **engine,
        ),
        scenario=scenario.to_dict(),
        rate_scale=rate_scale,
        epilogue_ticks=epilogue,
        replays_per_topology=int(replays),
        digest=dis_rep.digest,
        notes=(
            "equal replica counts on one device: 4 monolithic replicas "
            "against 3 prefill + 1 deep-slab decode specialist on the "
            "same trace; latency gates compare the minimum of the "
            "per-replay p95s over interleaved gc-free replays; "
            "steady_state_compiles counts kernel-library loads in the "
            "measured replay (PyTorch runs eagerly)"
        ),
        runs=runs,
        identity_findings=findings,
        gates=gates,
        passed=passed,
    )
    return report_doc, {mode: [(f, r) for f, r, _, _ in measured[mode]]
                        for mode in MODES}


def main(argv=None) -> int:
    from . import add_device_arg, tool_device, write_json

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="write the report's JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rate-scale", type=float, default=2.5,
                        help="arrival-rate multiplier on disagg_mix (sized "
                             "so the offered decode population fits the "
                             "specialist's 16-row slab)")
    parser.add_argument("--epilogue", type=int, default=60,
                        help="idle fleet ticks after the trace drains "
                             "(where in-flight handoffs deliver)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    report, _ = run_bench(device=tool_device(args), seed=args.seed,
                          rate_scale=args.rate_scale,
                          epilogue=args.epilogue)
    if args.out:
        write_json(args.out, report, indent=2)
        print(f"# wrote {args.out}")
    ledger = report["runs"]["disagg"]["ledger"]
    print(f"ledger: {ledger['delivered_total']} delivered / "
          f"{ledger['failed_total']} failed / {ledger['pending']} pending")
    print(f"gates: {report['gates']}")
    print(f"# {'PASS' if report['passed'] else 'FAIL'}")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
