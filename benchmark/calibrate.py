#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 5] [--out FILE]

The benchmark's own runs never run this.  In one process, for each of
``--seeds``: one run of the cell's loop at a short window, printing
the numbers it compared (the program's lower readings).  For each of
``--control-seeds``, the control, at the cell's own sizes:

- training: the reference in fp8 (every product's operands rounded to
  float8 e4m3 under a per-tensor scale) against the reference in
  float32 over the same weights, batches and dropout masks (drawn from
  the seed), and the half-batch fault (the reference over the first
  half of each batch, the mean taken over that half) against the same;
- serving: the widest reference gap of the tokens that the fp8 forward
  puts first, teacher-forced over the prompts and tokens that the
  program served for that seed.

One JSON line per reading on standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None, root: Path = ROOT, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import checks, spec, weights
    from benchmark.reference.precision import float32_exact

    cell = spec.load_cell(args.workload, root)
    device = torch.device(device or "cuda")
    loop_kind = spec.load_loop(cell["traffic"]["loop"])
    out = open(args.out, "a") if args.out else None

    def emit(record):
        record = dict(record, workload=args.workload)
        line = json.dumps(record, default=float)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def program(seed):
        t0 = time.perf_counter()
        result = loop_kind.run(spec.RunArgs(
            cell=args.workload, config=cell["config"], traffic=cell["traffic"],
            seed=seed, seconds=args.seconds, trace=False, device=device,
            out_dir=root / "build" / "calibrate" / f"{args.workload}.{seed}",
            t_start=t0))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return result

    loop = cell["traffic"]["loop"]
    served = {}
    for seed in args.seeds:
        result = program(seed)
        served[seed] = result.get("served")
        emit(dict(kind="program", seed=seed,
                  numbers={k: v["value"] for k, v in result["checks"].items()},
                  notes=result["notes"], end_to_end=result["end_to_end"],
                  memory_peak_bytes=result["memory_peak_bytes"]))
    for seed in args.control_seeds:
        with float32_exact():
            if loop == "train":
                from benchmark.loops import train as tr_loop
                from benchmark.reference import bert as ref_bert

                cfg = tr_loop.model_fields(cell["config"])
                run_cfg, traffic = cell["config"]["run"], cell["traffic"]
                units = weights.make(
                    ref_bert.layout(cfg, run_cfg["num_classes"]), seed,
                    device, cfg["initializer_range"])
                batches = [tuple(torch.from_numpy(a).to(device)
                                 for a in tr_loop.make_batch(
                                     traffic, cfg, run_cfg["num_classes"],
                                     seed, i)[:4])
                           for i in range(int(traffic["check_steps"]))]
                rows = int(traffic["check"]["block_rows"])
                lr = run_cfg["lr"]
                masks = ref_bert.draw_masks(
                    cfg, int(traffic["batch"]), int(traffic["seq"]),
                    len(batches), seed, device)
                ref = ref_bert.train(units, cfg, batches, lr, rows,
                                     masks=masks)
                low = ref_bert.train(units, cfg, batches, lr, rows,
                                     quant="fp8", masks=masks)
                half = ref_bert.train(units, cfg, batches, lr, rows,
                                      rows=int(traffic["batch"]) // 2,
                                      masks=masks)
                for kind, other in (("control_fp8", low),
                                    ("fault_half_batch", half)):
                    found = checks.train_numbers(other, ref)
                    emit(dict(kind=kind, seed=seed, **found))
                del units, ref, low, half, masks
            else:
                from benchmark.loops import serve_closed as sv_loop
                from benchmark.reference import gpt as ref_gpt

                if served.get(seed) is None:
                    served[seed] = program(seed)["served"]
                cfg = sv_loop.model_fields(cell["config"])
                units = weights.make(ref_gpt.layout(cfg), seed, device,
                                     cfg["initializer_range"])
                gaps, low = [], []
                for prompt, tokens in served[seed]:
                    found = ref_gpt.served_gaps(
                        units, cfg, torch.from_numpy(prompt).to(device),
                        torch.from_numpy(tokens).to(device), control="fp8")
                    gaps.append(found["gap"])
                    low.append(found["control_gap"])
                emit(dict(kind="control_fp8", seed=seed,
                          numbers=dict(logit_gap=max(low)),
                          program_gap=max(gaps)))
                del units
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
