"""Profile a config's model and devices and preview its allocations (the
port of ``tools/profile_allocation.py``).

    python -m skycomputing_tpu_torch.tools.profile_allocation \\
        -c skycomputing_tpu_torch/configs/bert_pipeline.py \\
        [--strategies even,dynamic,optimal] [--json PATH] [--device cpu]

Prints the per-unit profile (FLOPs or, under ``SKYTPU_PROFILE=timed``,
measured seconds, and memory; one row per unit type), the per-worker
device profile (skewed by the stimulator under ``STIMULATE``) and the
partition each strategy would choose, without building the pipeline or
training.  The model profile's launches of the flash kernel (B1), by
body, are reported beside it: under ``SKYTPU_FLASH=1`` the timed
profile runs each attention unit through B1 on the card.  ``--json``
writes the figures.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from . import add_device_arg, device_record, tool_device, write_json


def _flash_launches() -> Dict[str, int]:
    from ..ops.flash_attention import flash_attention

    return dict(flash_attention.body_launches)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--strategies", default="even,dynamic,optimal",
                        help="comma-separated subset of even,dynamic,optimal")
    parser.add_argument("--json", default=None,
                        help="write the profiles and partitions here")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = tool_device(args)

    from ..builder import build_data_generator
    from ..config import load_config
    from ..dynamics import (
        Allocator,
        DeviceBenchmarker,
        ModelBenchmarker,
        WorkerManager,
    )

    cfg = load_config(args.config)
    wm = WorkerManager()
    wm.load_worker_pool_from_config(cfg.worker_config)
    bench_cfg = cfg.allocator_config["benchmark_config"]
    model_bench = ModelBenchmarker(
        cfg.model_config,
        build_data_generator(**bench_cfg["model"]["data_generator_cfg"]),
        param_scale=bench_cfg["model"].get("param_scale", 2),
        device=device,
        timed=bench_cfg["model"].get("timed", False),
    )
    # the device benchmarker turns the stimulator on under STIMULATE
    device_bench = DeviceBenchmarker(
        wm,
        build_data_generator(**bench_cfg["device"]["data_generator_cfg"]),
        bench_cfg["device"]["model_config"],
        iterations=bench_cfg["device"].get("iterations", 5),
        devices=[device],
    )

    before = _flash_launches()
    units, mem = model_bench.benchmark()
    flash = {body: n - before.get(body, 0)
             for body, n in _flash_launches().items()
             if n != before.get(body, 0)}
    timed = bench_cfg["model"].get("timed", False)
    what = "seconds" if timed else "flops"
    print(f"== model profile ({len(cfg.model_config)} units, {what}) ==")
    shown = set()
    for i, layer_cfg in enumerate(cfg.model_config):
        key = layer_cfg["layer_type"]
        if key in shown:
            continue  # one row per unit type; repeats profile alike
        shown.add(key)
        count = sum(1 for c in cfg.model_config if c["layer_type"] == key)
        tag = f" x{count}" if count > 1 else ""
        print(f"  [{i:3d}] {key:28s}{tag:6s} {units[i]:.3e} {what}  "
              f"{mem[i]:8.1f} MB")
    print(f"  total: {sum(units):.3e} {what}, {sum(mem):.1f} MB")
    print(f"  flash kernel launches by body: {flash or 'none'}")

    stimulated = os.getenv("STIMULATE") is not None
    print(f"\n== device profile ({wm.size} workers"
          f"{', stimulated' if stimulated else ''}) ==")
    profile = device_bench.benchmark()
    for name, p in profile.items():
        print(f"  {name:10s} time={p['time']:.4f}s  "
              f"avai_mem={p['avai_mem']:.0f} MB")

    partitions: Dict[str, object] = {}
    for strategy in args.strategies.split(","):
        strategy = strategy.strip()
        wm2 = WorkerManager()
        wm2.load_worker_pool_from_config(cfg.worker_config)
        allocator = Allocator(cfg.model_config, wm2, model_bench,
                              device_bench)
        allocate = getattr(allocator, f"{strategy}_allocate", None)
        if allocate is None:
            print(f"\n== {strategy}: unknown strategy ==")
            continue
        try:
            allocate()
        except (RuntimeError, ValueError) as exc:
            print(f"\n== {strategy}: allocation failed: {exc} ==")
            partitions[strategy] = f"failed: {exc}"
            continue
        print(f"\n== {strategy} partition ==")
        counts = []
        for w in sorted(wm2.worker_pool, key=lambda w: w.rank):
            n = len(w.model_config or [])
            counts.append(n)
            print(f"  stage {w.rank:3d} ({w.name:10s}) {n:4d} layers "
                  f"{'#' * n}")
        partitions[strategy] = counts

    if args.json:
        write_json(args.json, dict(
            profile=what, units=units, memory_mb=mem, flash_launches=flash,
            devices=profile, stimulated=stimulated, partitions=partitions,
            device=device_record(device)))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
