#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for.  The cell's traffic file names its loop kind; the module of
that kind (``benchmark/loops/<kind>.py``) sets up the program
(``skycomputing_tpu_torch``), warms it, measures for ``--seconds``, and
checks what the timed path produced against the plain float32
reference.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit, which also end
standard error.  Without the cards, or without the program, it exits
non-zero and prints no result.  Build and kernel caches stay under the
checkout's ``build/``, and each run writes its logs and trace under
``build/benchmark/``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(time.clock_gettime(time.CLOCK_BOOTTIME) - started, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "skycomputing_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    """JSON-safe: a float that is not finite becomes None."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """``device``: run there without looking for a card (tests)."""
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec
    from benchmark.harness.peaks import peaks_for

    cell = spec.load_cell(args.workload, root)
    import torch

    if device is None:
        chips = int(cell["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    try:
        import skycomputing_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program under test is missing: {exc}", file=sys.stderr)
        return 3
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    loop_kind = spec.load_loop(cell["traffic"]["loop"])
    result = loop_kind.run(spec.RunArgs(
        cell=args.workload, config=cell["config"], traffic=cell["traffic"],
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device,
        out_dir=root / "build" / "benchmark"
        / f"{args.workload}.{args.seed}.{args.trace}",
        t_start=T_START))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4

    metrics = {}
    trace = result.get("trace")
    if args.trace:
        ctx = dict(result["layer"], peaks=peaks_for(kind),
                   traffic=cell["traffic"], config=cell["config"])
        for m in cell["per_layer"]:
            value = spec.load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": result["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=kind, count=1,
               memory_peak_bytes=result["memory_peak_bytes"])
    line = dict(correct=bool(result["correct"]),
                attempted=result["attempted"], failed=result["failed"],
                metrics=metrics, device=dev)
    if args.trace and trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = dict(device_ops=trace["device_ops"],
                                 idle_gaps=trace["idle_gaps"])
    line["checks"] = result["checks"]
    print(f"notes: {json.dumps(_finite(result['notes']))}", file=sys.stderr)
    for name, item in result["checks"].items():
        print(f"check {name}: {item['value']!r} (limit {item['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
