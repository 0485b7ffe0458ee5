"""Pipeline step overhead: host dispatch against device compute (the port
of ``tools/bench_step_overhead.py``).

A pipeline step's wall time has two parts the device cannot see apart:
the host's issue loops (dispatch) and its waits on the device (compute).
This tool measures the split on the JAX tool's model — tiny BERT,
float32, 3 encoder units, 4 even stages, M=8 microbatches, batch 16 x 32
— for both schedules, from :class:`~..parallel.pipeline.PipelineStats`
(the record ``MetricsHook`` ships per training step): each figure the
median over ``STEPS`` steps, the best of ``ROUNDS`` rounds.  Every stage
runs on the one device (the card, or ``--device cpu``).

It also measures tracing's cost: the step with the telemetry tracer on
against off in paired rounds, the events a traced step records, and the
record cost of one event (``events_per_step x cost_per_event`` over the
step is the robust form of the bound; wall-clock deltas on a busy host
fall either side of zero).

``--mesh`` compares the per-device loop (8 single-position stages, the
only shape it expresses) with :class:`~..parallel.MeshPipelineModel`
on ``Allocator.mesh_allocate``'s plan at JAX's two operating points
(4 stages x 1 position, timed; 4 x dp=2, the multi-chip shape), every
position on the one device, 12 units, M=8.  It reports the operations
the host issues per microbatch tick (every aten call a step makes,
counted by a ``TorchDispatchMode``; the card's kernel launches per step
from ``torch.profiler`` beside them), the dispatch time and share
(``PipelineStats`` and the traced ``trace_report`` section) and the
step time, with a bitwise equivalence leg (mesh against per-device on
one allocation, both schedules, two steps each), gated as JAX's are,
into ``--out`` (default ``build/bench_mesh_pipeline.json``); the exit
code is 1 when a gate fails.

What has no counterpart: the JAX tool's HOTPATH/legacy A/B (the port
has one dispatch path; its figures sit under ``hotpath``, JAX's key),
and its ``transfers``, ``transfers_elided`` and ``compiles`` counts
(nothing compiles, and ``Tensor.to`` to the same device is no copy);
under ``--mesh``, ``programs_per_step`` and ``puts_per_step`` (JAX's
counts of compiled programs and ``device_put`` calls) give way to
``ops_per_step`` and ``kernels_per_step``.

Usage::

    python -m skycomputing_tpu_torch.tools.bench_step_overhead \\
        [--no-trace] [--trace-out PATH] [--mesh [--out PATH]] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import add_device_arg, device_record, tool_device, write_json

N_DEVICES = 8
STEPS = 6    # timed steps per (round, schedule)
ROUNDS = 4   # paired rounds; each mode's best round is reported
MESH_M = 8   # microbatches under --mesh; rows/microbatch = 2 -> dp cap 2


def _units(num_encoder_units: int):
    from ..models import bert_config, bert_layer_configs

    cfg = bert_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    return bert_layer_configs(cfg, num_encoder_units=num_encoder_units,
                              num_classes=3, deterministic=True)


def _batch(seed: int, rows: int, length: int, device):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(
        rng.integers(5, 1024, size=(rows, length)).astype(np.int64))
    labels = torch.from_numpy(
        rng.integers(0, 3, size=(rows,)).astype(np.int64))
    data = (ids, torch.zeros_like(ids), torch.ones_like(ids))
    return tuple(x.to(device) for x in data), labels.to(device)


def _pool(n: int, prefix: str = "node-"):
    from ..dynamics import WorkerManager

    wm = WorkerManager()
    wm.load_worker_pool_from_config(
        [dict(name=f"{prefix}{i}", device_config=dict(device_index=i))
         for i in range(n)])
    return wm


def _params(model_cfg):
    from ..dynamics import ParameterServer

    return ParameterServer(model_cfg,
                           generator=torch.Generator().manual_seed(0))


def _build(schedule: str, device):
    from ..dynamics import Allocator
    from ..ops.losses import cross_entropy_loss
    from ..parallel import PipelineModel, sgd

    model_cfg = _units(3)
    data, labels = _batch(0, 16, 32, device)
    wm = _pool(4)
    Allocator(model_cfg, wm, None, None).even_allocate()
    model = PipelineModel(wm, _params(model_cfg), sgd(1e-2),
                          cross_entropy_loss, devices=[device],
                          num_microbatches=8, schedule=schedule)
    return model, data, labels


def _step(model, data, labels, seed: int) -> float:
    return model.train_step(data, labels,
                            generator=torch.Generator().manual_seed(seed))


def _sample(model, data, labels, base_key: int) -> Dict[str, float]:
    """Median step wall time, dispatch and device wait over STEPS
    steps."""
    walls, dispatches, waits = [], [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        _step(model, data, labels, base_key + i)
        walls.append(time.perf_counter() - t0)
        s = model.stats
        dispatches.append(s.dispatch_s)
        waits.append(s.compute_wait_s)
    return dict(
        step_wall_s=float(np.median(walls)),
        dispatch_s=float(np.median(dispatches)),
        compute_wait_s=float(np.median(waits)),
    )


def _trace_overhead(model, data, labels) -> Dict[str, float]:
    """Tracing on/off paired rounds and the per-event record cost, on
    one warm model."""
    from .. import telemetry

    on_steps, off_steps = [], []
    events_per_step = 0
    for r in range(ROUNDS):
        tracer = telemetry.enable_tracing(capacity=1 << 20)
        n0 = tracer.event_count
        on_steps.append(
            _sample(model, data, labels, base_key=50 + r)["step_wall_s"])
        events_per_step = max(events_per_step,
                              (tracer.event_count - n0) // STEPS)
        telemetry.disable_tracing()
        off_steps.append(
            _sample(model, data, labels, base_key=50 + r)["step_wall_s"])
    # one complete() is the dearest hot-path record (two clock reads, a
    # tuple, an append)
    tracer = telemetry.Tracer(capacity=1 << 20)
    lane = tracer.lane("bench", "events")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        tracer.complete("e", lane, tracer.now())
    cost_us = (time.perf_counter() - t0) / n * 1e6
    on_s, off_s = min(on_steps), min(off_steps)
    return dict(
        step_wall_s_tracing_on=on_s,
        step_wall_s_tracing_off=off_s,
        wall_overhead_pct=(on_s / off_s - 1.0) * 100.0,
        events_per_step=events_per_step,
        cost_per_event_us=cost_us,
        modeled_overhead_pct=(
            events_per_step * cost_us / (off_s * 1e6) * 100.0),
    )


def run_default(device, trace: bool = True,
                trace_out: Optional[str] = None) -> dict:
    """The default mode's report; ``trace_out`` also writes a traced
    window of three gpipe steps there (a Chrome trace)."""
    report = {}
    tracing = None
    for schedule in ("gpipe", "1f1b"):
        model, data, labels = _build(schedule, device)
        _step(model, data, labels, 0)  # warm
        rounds = [_sample(model, data, labels, base_key=10 + r)
                  for r in range(ROUNDS)]
        best = min(rounds, key=lambda s: s["step_wall_s"])
        best["dispatch_fraction"] = (
            best["dispatch_s"] / best["step_wall_s"]
            if best["step_wall_s"] > 0 else 0.0)
        report[schedule] = {"hotpath": best}
        if trace and schedule == "gpipe":
            tracing = _trace_overhead(model, data, labels)
        if trace_out and schedule == "gpipe":
            write_json(trace_out, {"traceEvents": _traced_window(
                model, data, labels)}, indent=None)
    out = {"steps": STEPS, "rounds": ROUNDS, "schedules": report,
           "device": device_record(device)}
    if tracing is not None:
        out["tracing"] = tracing
    return out


# --------------------------------------------------------------------------
# --mesh: the per-device loop against mesh-native stages
# --------------------------------------------------------------------------


class _OpCount(TorchDispatchMode):
    """Counts the aten operations the host issues."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


class _UniformDevices:
    def __init__(self, wm):
        self._wm = wm

    def benchmark(self):
        return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                for w in self._wm.worker_pool}


class _UniformUnits:
    def __init__(self, n: int):
        self._n = n

    def benchmark(self):
        return [1.0] * self._n, [0.1] * self._n


def _mesh_worlds(device):
    """(per-device model, timed mesh model, multi-chip mesh model,
    data, labels): one 12-unit tiny BERT, one 8-position budget, one
    batch and microbatching."""
    from ..dynamics import Allocator
    from ..ops.losses import cross_entropy_loss
    from ..parallel import MeshPipelineModel, PipelineModel, sgd

    model_cfg = _units(3)
    data, labels = _batch(0, 16, 32, device)
    devices = [device] * N_DEVICES
    wm_base = _pool(N_DEVICES)
    Allocator(model_cfg, wm_base, None, None).even_allocate()
    base = PipelineModel(wm_base, _params(model_cfg), sgd(1e-2),
                         cross_entropy_loss, devices=devices,
                         num_microbatches=MESH_M)

    def mesh_model(**mesh_kwargs):
        wm = _pool(N_DEVICES)
        Allocator(model_cfg, wm, _UniformUnits(len(model_cfg)),
                  _UniformDevices(wm)).mesh_allocate(**mesh_kwargs)
        return MeshPipelineModel(wm, _params(model_cfg), sgd(1e-2),
                                 cross_entropy_loss, devices=devices,
                                 num_microbatches=MESH_M)

    mesh = mesh_model(max_stages=4, max_chips_per_stage=1)
    mesh_mc = mesh_model(max_chips_per_stage=16 // MESH_M)
    return base, mesh, mesh_mc, data, labels


def _issue_counts(model, data, labels, device) -> Dict[str, Optional[int]]:
    """Host operations per step (one untimed step under the counting
    mode) and, on the card, the kernel launches of one profiled step."""
    counter = _OpCount()
    with counter:
        _step(model, data, labels, 70)
    kernels = None
    if device.type == "cuda":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _step(model, data, labels, 71)
        kernels = sum(
            1 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA)
    return dict(ops_per_step=counter.count, kernels_per_step=kernels)


def _mesh_sample(model, data, labels, base_key: int) -> Dict[str, float]:
    walls, dispatches = [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        _step(model, data, labels, base_key + i)
        walls.append(time.perf_counter() - t0)
        dispatches.append(model.stats.dispatch_s)
    return dict(step_wall_s=float(np.median(walls)),
                dispatch_s=float(np.median(dispatches)))


def _traced_window(model, data, labels) -> List[dict]:
    """The Chrome-trace events of three traced steps, each in an
    ``iter`` span (what ``TraceHook`` records)."""
    from .. import telemetry

    tracer = telemetry.enable_tracing(capacity=1 << 20)
    t0 = tracer.now()
    try:
        for i in range(3):
            with tracer.span("iter", tracer.lane("runner", "iters")):
                _step(model, data, labels, 90 + i)
        return tracer.to_chrome(since_us=t0)["traceEvents"]
    finally:
        telemetry.disable_tracing()


def _mesh_trace_dispatch(model, data, labels) -> Dict[str, float]:
    """``trace_report``'s host-dispatch section over a short traced
    window: (share of the window, dispatch ms per step)."""
    from ..telemetry.analysis import analyze

    d = analyze(_traced_window(model, data, labels))["dispatch"]
    return dict(share=float(d["share"]),
                ms_per_step=float(d["total_ms"]) / int(d["steps"]))


def _mesh_equivalence(device) -> Dict[str, bool]:
    """Bitwise loss and parameter equality: mesh against per-device on
    one allocation (one position per stage), two steps per schedule,
    cumulative."""
    from ..dynamics import Allocator
    from ..ops.losses import cross_entropy_loss
    from ..parallel import MeshPipelineModel, PipelineModel, sgd

    model_cfg = _units(2)
    data, labels = _batch(1, 8, 16, device)

    def build(engine):
        wm = _pool(3, prefix="n")
        Allocator(model_cfg, wm, None, None).even_allocate()
        return engine(wm, _params(model_cfg), sgd(1e-2),
                      cross_entropy_loss, devices=[device] * 3,
                      num_microbatches=4)

    mpmd, mesh = build(PipelineModel), build(MeshPipelineModel)

    def bitwise_equal() -> bool:
        return all(torch.equal(a, b)
                   for s1, s2 in zip(mpmd.stages, mesh.stages)
                   for a, b in zip(s1.parameters, s2.parameters))

    out = {}
    for schedule in ("gpipe", "1f1b"):
        mpmd.schedule = mesh.schedule = schedule
        losses_equal = True
        for i in range(2):
            losses_equal &= (_step(mpmd, data, labels, 100 + i)
                             == _step(mesh, data, labels, 100 + i))
        out[f"bitwise_equal_{schedule}"] = bitwise_equal()
        out[f"losses_equal_{schedule}"] = bool(losses_equal)
    return out


def run_mesh(device) -> dict:
    base, mesh, mesh_mc, data, labels = _mesh_worlds(device)
    for model in (base, mesh, mesh_mc):  # warm
        _step(model, data, labels, 0)
    timed = (("per_device", base), ("mesh", mesh),
             ("mesh_multichip", mesh_mc))
    rounds: Dict[str, List[dict]] = {mode: [] for mode, _ in timed}
    for r in range(ROUNDS):  # paired rounds: a drift hits all alike
        for mode, model in timed:
            rounds[mode].append(
                _mesh_sample(model, data, labels, base_key=10 + r))
    report = {}
    for mode, model in timed:
        agg = min(rounds[mode], key=lambda s: s["step_wall_s"])
        agg["dispatch_fraction"] = (
            agg["dispatch_s"] / agg["step_wall_s"]
            if agg["step_wall_s"] > 0 else 0.0)
        agg.update(_issue_counts(model, data, labels, device))
        agg["dispatches_per_tick"] = agg["ops_per_step"] / MESH_M
        agg["stages"] = len(model.stages)
        trace = _mesh_trace_dispatch(model, data, labels)
        agg["trace_dispatch_share"] = trace["share"]
        agg["trace_dispatch_ms_per_step"] = trace["ms_per_step"]
        report[mode] = agg
    report["mesh"]["chips_per_stage"] = mesh.chips_per_stage
    report["mesh_multichip"]["chips_per_stage"] = mesh_mc.chips_per_stage
    report["mesh_multichip"]["note"] = (
        "multi-chip shape (dp=2 sub-meshes); every position of the mesh "
        "is the one device, so a dp stage issues its shards' work one "
        "after another on it")
    equivalence = _mesh_equivalence(device)

    pd, ms = report["per_device"], report["mesh"]
    mc = report["mesh_multichip"]
    tick_ratio = pd["dispatches_per_tick"] / ms["dispatches_per_tick"]
    mc_tick_ratio = pd["dispatches_per_tick"] / mc["dispatches_per_tick"]
    step_ratio = ms["step_wall_s"] / pd["step_wall_s"]
    gates = {
        "dispatches_per_tick_ratio": dict(
            value=round(tick_ratio, 3), target=">= 2.0",
            ok=tick_ratio >= 2.0),
        "multichip_dispatches_per_tick_ratio": dict(
            value=round(mc_tick_ratio, 3), target=">= 2.0",
            ok=mc_tick_ratio >= 2.0),
        "step_time_no_worse": dict(
            value=round(step_ratio, 3), target="<= 1.0",
            ok=step_ratio <= 1.0),
        "dispatch_time_reduced": dict(
            value=[round(pd["dispatch_s"] * 1e3, 2),
                   round(ms["dispatch_s"] * 1e3, 2)],
            target="mesh < per_device (ms/step)",
            ok=ms["dispatch_s"] < pd["dispatch_s"]),
        "trace_dispatch_time_reduced": dict(
            value=[round(pd["trace_dispatch_ms_per_step"], 2),
                   round(ms["trace_dispatch_ms_per_step"], 2)],
            target="mesh < per_device (ms/step)",
            ok=(ms["trace_dispatch_ms_per_step"]
                < pd["trace_dispatch_ms_per_step"])),
        "params_bitwise_equal": dict(
            value=equivalence, target="all true",
            ok=all(equivalence.values())),
    }
    return {
        "what": (
            "mesh-native stage execution A/B: the per-device issue loop "
            "(8 single-position stages) against MeshPipelineModel on "
            "mesh_allocate's plan, same model, same 8-position budget "
            "(every position on one device), M=8 microbatches; the timed "
            "mesh point is 4 stages x 1 position, the dp=2 shape rides "
            "along"),
        "tool": (
            f"python -m skycomputing_tpu_torch.tools.bench_step_overhead "
            f"--mesh (tiny BERT, 12 units, median of {STEPS} steps, best "
            f"of {ROUNDS} paired rounds)"),
        "device": device_record(device),
        "modes": report,
        "equivalence": equivalence,
        "gates": gates,
    }


def _print_default(out: dict) -> None:
    for schedule, by_mode in out["schedules"].items():
        agg = by_mode["hotpath"]
        print(f"# {schedule:>5}: step {agg['step_wall_s'] * 1e3:8.2f} ms | "
              f"dispatch {agg['dispatch_s'] * 1e3:7.2f} ms "
              f"({agg['dispatch_fraction'] * 100:5.1f}%) | device wait "
              f"{agg['compute_wait_s'] * 1e3:7.2f} ms")
    tr = out.get("tracing")
    if tr is not None:
        print(f"# tracing (gpipe): step "
              f"{tr['step_wall_s_tracing_off'] * 1e3:.2f} -> "
              f"{tr['step_wall_s_tracing_on'] * 1e3:.2f} ms "
              f"({tr['wall_overhead_pct']:+.2f}% wall) | "
              f"{tr['events_per_step']} events/step x "
              f"{tr['cost_per_event_us']:.2f} us/event = "
              f"{tr['modeled_overhead_pct']:.3f}% modeled overhead")


def _print_mesh(out: dict) -> int:
    for mode, agg in out["modes"].items():
        kernels = agg["kernels_per_step"]
        print(f"# {mode:>14}: {agg['stages']} stages | step "
              f"{agg['step_wall_s'] * 1e3:8.2f} ms | dispatch "
              f"{agg['dispatch_s'] * 1e3:7.2f} ms "
              f"({agg['dispatch_fraction'] * 100:5.1f}%; trace share "
              f"{agg['trace_dispatch_share'] * 100:5.1f}%) | "
              f"{agg['dispatches_per_tick']:.1f} ops/tick | kernels/step "
              f"{'not measured' if kernels is None else kernels}")
    gates = out["gates"]
    failed = [k for k, g in gates.items() if not g["ok"]]
    for k in failed:
        print(f"# GATE FAILED: {k}: {gates[k]}", file=sys.stderr)
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", action="store_true",
                        help="per-device loop against mesh-native stages")
    parser.add_argument("--out", default=os.path.join(
        "build", "bench_mesh_pipeline.json"), help="--mesh's JSON file")
    parser.add_argument("--no-trace", action="store_true",
                        help="skip the tracing-overhead section")
    parser.add_argument("--trace-out", default=None,
                        help="also write a traced window of three gpipe "
                             "steps here (Chrome trace; default mode)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = tool_device(args)
    if not args.mesh:
        out = run_default(device, trace=not args.no_trace,
                          trace_out=args.trace_out)
        print(json.dumps(out), flush=True)
        _print_default(out)
        return 0
    out = run_mesh(device)
    write_json(args.out, out, indent=2)
    print(json.dumps(out), flush=True)
    rc = _print_mesh(out)
    print(f"# wrote {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
