"""Validate the bench's schedule model against measured pipelined steps
(the port of ``tools/validate_schedule_model.py``).

The bench scores allocations with the GPipe fill-drain model

    t_step = sum_k tau_k / M  +  (M-1)/M * max_k tau_k

built from per-stage times measured in isolation.  This tool checks
its two load-bearing claims against measured steps:

1. **Composition**: the isolated per-stage taus add up to the measured
   pipelined ``train_step``.  On serial devices (every mesh position on
   one card, as here, or the CPU) the schedule collapses to sum(tau);
   on parallel devices it is the full model.
2. **Fill-drain structure**: :class:`~..parallel.CompiledBertPipeline`'s
   forward over M microbatches.  On parallel devices it follows
   (M + S - 1) ticks of size B/M: wall(M) ~ (M + S - 1) / M.  JAX's
   compiled program also runs its idle cells, so on serial devices
   every tick costs S cells and the same shape holds; the port's
   engine leaves idle cells out, so on serial devices it runs the
   M x S real cells one after another and wall(M) ~ 1: no bubble is
   paid.  The tool holds each regime to its own shape.

:func:`probe_device_concurrency` reports serial devices on one card:
every position runs on its one stream.  Exit 0 when both deltas are
under 15%; ``SKYTPU_SCHEDVAL_JSON`` names a JSON file for the figures.

Usage::

    python -m skycomputing_tpu_torch.tools.validate_schedule_model \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import time
import types
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..dynamics.estimator import synchronize
from . import add_device_arg, device_record, tool_device

N_POSITIONS = 4
PRESET = "base"  # the BERT preset of both checks


def _sync(devices: Sequence[torch.device]) -> None:
    for d in set(devices):
        synchronize(d)


def probe_device_concurrency(devices: Sequence[torch.device],
                             repeats: int = 3,
                             clock: Callable[[], float] = time.perf_counter
                             ) -> float:
    """Ratio all-N / one (1.0 = perfect overlap, N = serial), each time
    the median of ``repeats`` samples taken in turns: on a shared host
    another process can stretch one sample, or slow a stretch of them,
    and the turns spread that over both sides. ``clock`` reads both
    sides: wall time behind a device sync on the card (CPU time cannot
    see device work), the calling thread's CPU time on the CPU, where
    every position runs on that thread and other processes cannot
    stretch either side."""
    def f(a):
        return torch.tanh(a @ a).sum()

    def timed(xs) -> float:
        t0 = clock()
        for x in xs:
            f(x)
        _sync(devices)
        return clock() - t0

    xs = [torch.ones((1200, 1200), device=d) for d in devices]
    for x in xs:
        f(x)
    _sync(devices)
    t_all, t_one = [], []
    for _ in range(repeats):
        t_all.append(timed(xs))
        t_one.append(timed(xs[:1]))
    return float(np.median(t_all) / np.median(t_one))


def schedule_step_time(taus, M: int) -> float:
    taus = np.asarray(taus, dtype=np.float64)
    return float(taus.sum() / M + (M - 1) / M * taus.max())


def _batch(cfg, B: int, L: int, device):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(
        rng.integers(5, cfg.vocab_size, (B, L)).astype(np.int64)).to(device)
    labels = torch.from_numpy(
        rng.integers(0, 3, (B,)).astype(np.int64)).to(device)
    return (ids, torch.zeros_like(ids), torch.ones_like(ids)), labels


@contextlib.contextmanager
def _pipeline_clock(clock: Callable[[], float]):
    """The pipeline module's timings (its stage samples and a step's
    phase seconds) read from ``clock`` while the block runs."""
    from ..parallel import pipeline

    real = pipeline.time
    shim = types.SimpleNamespace(**{
        name: getattr(real, name) for name in dir(real)
        if not name.startswith("_")})
    shim.perf_counter = clock
    pipeline.time = shim
    try:
        yield
    finally:
        pipeline.time = real


def validate_composition(devices: Sequence[torch.device], serial: bool,
                         preset: str = "base",
                         clock: Optional[Callable[[], float]] = None
                         ) -> float:
    """Measured pipelined ``train_step`` against the tau-built model;
    returns |measured - predicted| / measured.

    ``clock`` (default ``time.perf_counter``) times both sides: the
    taus, the steps and the accumulations.  On the CPU with one torch
    thread, ``time.thread_time`` reads the compute thread's own CPU
    time, which other processes on a shared host cannot stretch on one
    side only."""
    clock = clock or time.perf_counter
    with _pipeline_clock(clock):
        return _composition_delta(devices, serial, preset, clock)


def _composition_delta(devices, serial, preset, clock) -> float:
    from ..dynamics import Allocator, ParameterServer, WorkerManager
    from ..models import bert_config, bert_layer_configs
    from ..ops.losses import cross_entropy_loss
    from ..parallel import PipelineModel, sgd

    n_stages = min(N_POSITIONS, len(devices))
    cfg = bert_config(preset, dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=n_stages * 2,
                                   num_classes=3, deterministic=True)
    wm = WorkerManager()
    # serial: every stage on one device queue, so measured == sum(tau)
    # is a clean, falsifiable claim
    wm.load_worker_pool_from_config(
        [dict(name=f"n{i}",
              device_config=dict(device_index=0 if serial else i),
              extra_config={}) for i in range(n_stages)])
    Allocator(model_cfg, wm, None, None).even_allocate()

    B, L, M = 16, 128, 4
    data, labels = _batch(cfg, B, L, devices[0])
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(0))
    model = PipelineModel(wm, ps, sgd(1e-3), cross_entropy_loss,
                          devices=list(devices), num_microbatches=M)

    model.train_step(data, labels)  # warm
    # taus at MICROBATCH size: the schedule executes B/M slices, and
    # throughput is not linear in batch at these sizes
    mb = tuple(x[: B // M] for x in data)
    # the taus and the steps in turns, 5 rounds, each the median over
    # them: a change of the host's speed during the check (other
    # processes on a shared host) lands on both sides alike.  JAX's tool
    # takes its 5 tau samples, then its 5 steps
    tau_rounds, samples = [], []
    for i in range(5):
        tau_rounds.append(model.measure_stage_times(mb, repeats=1,
                                                    inner_iters=2))
        model.train_step(data, labels,
                         generator=torch.Generator().manual_seed(i))
        s = model.stats
        samples.append(s.forward_s + s.backward_s)
    taus_mb = np.median(np.asarray(tau_rounds), axis=0)
    taus = [float(t) * M for t in taus_mb]  # full-batch-equivalent
    measured = float(np.median(samples))

    # the schedule model charges fwd+bwd compute only; the real step also
    # pays (M-1) gradient accumulations per stage: measure and charge
    # them, so the comparison isolates the schedule
    t_acc = 0.0
    for stage in model.stages:
        grads = [torch.zeros_like(p) for p in stage.parameters]
        torch._foreach_add(grads, grads)
        _sync([stage.device])
        t0 = clock()
        for _ in range(3):
            torch._foreach_add(grads, grads)
        _sync([stage.device])
        t_acc += (clock() - t0) / 3 * (M - 1)

    predicted_sched = (float(np.sum(taus)) if serial
                       else schedule_step_time(taus, M))
    predicted = predicted_sched + t_acc
    delta = abs(measured - predicted) / measured
    mode = "sum(tau) [serial devices]" if serial else f"GPipe model M={M}"
    print(f"composition: measured={measured:.3f}s predicted="
          f"{predicted:.3f}s (schedule {predicted_sched:.3f}s + "
          f"accumulation {t_acc:.3f}s) ({mode}) delta={delta * 100:.1f}%"
          f"  taus={[round(t, 3) for t in taus]}", flush=True)
    return delta


def fill_drain_shape(M: int, S: int, serial: bool) -> float:
    """The model's wall(M), per unit of per-microbatch work: (M + S -
    1) / M ticks on parallel devices; on serial ones the engine runs
    only the M x S real cells, a constant."""
    return 1.0 if serial else (M + S - 1) / M


def validate_fill_drain(devices: Sequence[torch.device], serial: bool,
                        preset: str = "base") -> List[float]:
    """Per M in (4, 8), |measured wall(M)/wall(2) - model ratio| /
    model ratio of the compiled pipeline's forward."""
    from ..models import bert_config
    from ..parallel import make_pipeline_mesh
    from ..parallel.spmd import CompiledBertPipeline

    S = min(N_POSITIONS, len(devices))
    mesh = make_pipeline_mesh(S, list(devices))
    cfg = bert_config(preset, dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    B, L = 16, 128
    (ids, types, mask), _ = _batch(cfg, B, L, devices[0])

    walls, models = {}, {}
    params = None
    for M in (2, 4, 8):
        pipe = CompiledBertPipeline(cfg, mesh, units_per_stage=2,
                                    num_microbatches=M)
        if params is None:
            params = pipe.init(0)
        with torch.no_grad():
            pipe._logits(params, ids, types, mask)
            _sync(devices)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(2):
                    pipe._logits(params, ids, types, mask)
                _sync(devices)
                best = min(best, (time.perf_counter() - t0) / 2)
        walls[M] = best
        models[M] = fill_drain_shape(M, S, serial)
        print(f"fill-drain: M={M} wall={best * 1e3:.1f}ms "
              f"model-shape={models[M]:.3f}", flush=True)
    deltas = []
    for M in (4, 8):
        measured_ratio = walls[M] / walls[2]
        model_ratio = models[M] / models[2]
        deltas.append(abs(measured_ratio - model_ratio) / model_ratio)
        print(f"fill-drain ratio M={M}/M=2: measured={measured_ratio:.3f} "
              f"model={model_ratio:.3f} delta={deltas[-1] * 100:.1f}%",
              flush=True)
    return deltas


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = tool_device(args)
    # every mesh position on the one device, as the card's phases place
    # them
    devices = [device] * N_POSITIONS
    ratio = probe_device_concurrency(devices)
    serial = ratio > 0.6 * N_POSITIONS
    print(f"device concurrency probe: ratio={ratio:.2f} -> "
          f"{'serial' if serial else 'parallel'} execution", flush=True)
    d1 = validate_composition(devices, serial, preset=PRESET)
    fill = validate_fill_drain(devices, serial, preset=PRESET)
    d2 = max(fill)
    ok = d1 < 0.15 and d2 < 0.15
    record = {
        "composition_delta_pct": d1 * 100,
        "fill_drain_delta_pct": {"4": fill[0] * 100, "8": fill[1] * 100},
        "fill_drain_worst_delta_pct": d2 * 100,
        "serial_devices": bool(serial),
        "concurrency_ratio": ratio,
        "device": device_record(device),
        "preset": PRESET,
        "threshold_pct": 15.0,
        "ok": bool(ok),
        "ts": datetime.datetime.now().isoformat(timespec="seconds"),
    }
    print(json.dumps(record), flush=True)
    print(f"schedule model validation: composition delta {d1 * 100:.1f}%, "
          f"fill-drain worst delta {d2 * 100:.1f}% -> "
          f"{'OK (<15%)' if ok else 'FAIL (>=15%)'}", flush=True)
    out_path = os.environ.get("SKYTPU_SCHEDVAL_JSON")
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
            fh.write("\n")
        print(f"schedule validation record -> {out_path}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
