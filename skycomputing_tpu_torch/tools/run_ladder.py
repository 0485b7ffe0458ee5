"""Run the experiment config ladder and summarize phase timings (the port
of ``tools/run_ladder.py``).

    python -m skycomputing_tpu_torch.tools.run_ladder            # all five
    python -m skycomputing_tpu_torch.tools.run_ladder --only even_4 optimal_8
    SKYTPU_PRESET=tiny python -m skycomputing_tpu_torch.tools.run_ladder \\
        --max-iters 3 --device cpu                                # smoke

Each rung (``skycomputing_tpu_torch/configs/ladder/<name>.py``) runs
the whole profile -> allocate -> train path through ``python -m
skycomputing_tpu_torch.launch`` in a fresh process (a config sets the
environment), with a time limit; the table reports the steady-state
phase means read back from the rung's ``allocation.log`` (the first
step, which warms up, left out), its losses, its allocation, and the
flash kernel's launches by body in each step (``KernelLaunchHook``'s
lines: the rungs run with ``SKYTPU_KERNEL_LAUNCHES=1``).  Logs go under ``--log-root`` (default ``build/ladder``), one
directory per rung, emptied first.  Exit 0 iff every rung exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Optional

from . import add_device_arg, tool_device, write_json

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LADDER = os.path.join(_REPO, "skycomputing_tpu_torch", "configs", "ladder")
CONFIGS = [
    "even_4",
    "optimal_8",
    "dynamic_8_stim",
    "optimal_32_96layer",
    "optimal_64_160layer",
]

# a diverged rung prints 'loss: nan': its timings are kept all the same
_PHASE = re.compile(r"loss: (\S+) \| forward time: ([\d.]+) \| "
                    r"backward time: ([\d.]+) \| step time: ([\d.]+)")
_ALLOC = re.compile(r"worker rank (\d+): layers \((\d+), (\d+)\)")
_LAUNCHES = re.compile(r"kernel launches: flash_attention (\{.*\})")


def _parse_log(log_root: str) -> dict:
    loss, fwd, bwd, step, flash = [], [], [], [], []
    layers_by_rank = {}
    for root, _, files in os.walk(log_root):
        if "allocation.log" not in files:
            continue
        with open(os.path.join(root, "allocation.log")) as fh:
            for line in fh:
                m = _PHASE.search(line)
                if m:
                    try:
                        loss.append(float(m.group(1)))
                    except ValueError:
                        loss.append(None)
                    fwd.append(float(m.group(2)))
                    bwd.append(float(m.group(3)))
                    step.append(float(m.group(4)))
                    flash.append({})
                    continue
                m = _LAUNCHES.search(line)
                if m and flash:
                    # the hook logs after the step's own line
                    flash[-1] = json.loads(m.group(1))
                    continue
                m = _ALLOC.search(line)
                if m:
                    layers_by_rank[int(m.group(1))] = (
                        int(m.group(3)) - int(m.group(2)))
    out = {"losses": loss, "flash_launches": flash}
    if layers_by_rank:
        out["allocation"] = [layers_by_rank[r]
                             for r in sorted(layers_by_rank)]
    if len(fwd) > 1:  # leave out the first step, which warms up
        fwd, bwd, step = fwd[1:], bwd[1:], step[1:]
    if fwd:
        out.update(fwd_s=sum(fwd) / len(fwd), bwd_s=sum(bwd) / len(bwd),
                   step_s=sum(step) / len(step), iters=len(fwd))
    return out


def run_one(name: str, max_iters: int, log_root: str,
            device: Optional[str], timeout: float = 3600) -> dict:
    # fresh logs: the runner's Logger appends, and an earlier run's
    # lines would corrupt the phase means
    shutil.rmtree(log_root, ignore_errors=True)
    env = dict(os.environ)
    env["SKYTPU_MAX_ITERS"] = str(max_iters)
    env["SKYTPU_LOG_ROOT"] = log_root
    env["SKYTPU_KERNEL_LAUNCHES"] = "1"  # KernelLaunchHook's log lines
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "skycomputing_tpu_torch.launch",
           "-c", os.path.join(LADDER, f"{name}.py")]
    if device:
        cmd += ["--device", device]
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        print(f"  {name}: timed out after {timeout:.0f}s")
        return {"config": name, "exit": "timeout"}
    if proc.returncode != 0 and proc.stderr:
        tail = "\n".join(proc.stderr.splitlines()[-5:])
        print(f"  {name} failed (exit {proc.returncode}); stderr tail:\n"
              f"{tail}")
    result = {"config": name, "exit": proc.returncode}
    result.update(_parse_log(log_root))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="*", default=None,
                        help="subset of config names (without .py)")
    parser.add_argument("--max-iters", type=int, default=5)
    parser.add_argument("--log-root", default=os.path.join("build",
                                                           "ladder"))
    parser.add_argument("--timeout", type=float, default=3600,
                        help="per-rung wall budget (s)")
    parser.add_argument("--json", default=None,
                        help="write the per-rung records to this JSON file")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    tool_device(args)  # raises here, before any rung, on a box with no card

    names = args.only or CONFIGS
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        print(f"unknown configs: {unknown}; known: {CONFIGS}")
        return 2

    rows = []
    for i, name in enumerate(names):
        print(f"[{i + 1}/{len(names)}] {name} ...", flush=True)
        rows.append(run_one(name, args.max_iters,
                            os.path.join(args.log_root, name), args.device,
                            timeout=args.timeout))

    if args.json:
        write_json(args.json, dict(
            max_iters=args.max_iters,
            preset=os.getenv("SKYTPU_PRESET", "(config default)"),
            device=args.device or "cuda", rungs=rows), indent=2)
        print(f"wrote {args.json}")

    print(f"\n{'config':24s} {'exit':>7s} {'fwd_s':>9s} {'bwd_s':>9s} "
          f"{'step_s':>9s}")
    for r in rows:
        if "fwd_s" in r:
            print(f"{r['config']:24s} {r['exit']!s:>7s} {r['fwd_s']:9.4f} "
                  f"{r['bwd_s']:9.4f} {r['step_s']:9.4f}")
        else:
            print(f"{r['config']:24s} {r['exit']!s:>7s} {'-':>9s} "
                  f"{'-':>9s} {'-':>9s}")
    return 0 if all(r["exit"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
