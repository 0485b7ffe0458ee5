#!/usr/bin/env python
"""How far ``chip_smoke.py``'s self-heal phase (phase 19) sits from its
detector's threshold, at two fault sizes, on one NVIDIA GPU.

Phase 19 trains BERT-large (75 units, 4 workers on one card, GPipe M=4)
for 20 steps with worker 0's stage made ``factor`` times slower from
iteration 4, and expects ``SelfHealHook(window=2, k_windows=2,
threshold=1.35)`` to heal once.  A window is divergent when both its
mean and the EWMA (alpha 0.4) exceed 1.35 x the baseline, and a healthy
window drags the baseline up by the same alpha; on one card a step is
the sum of the stages, so how much a slow stage slows the step depends
on the host.  This script runs the phase alone at each factor of
``--factors`` in turns (in order, then in reverse, ``--reps`` times),
printing after every iteration the hook's elapsed time, EWMA, baseline
and streak, then each run's heal iteration, divergences and step
medians; rows go to ``chiprun_out/selfheal_ab.json``.  Usage::

    python3 selfheal_ab.py [--factors 4 6] [--reps 1]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--factors", type=float, nargs="+",
                        default=[4.0, 6.0])
    parser.add_argument("--reps", type=int, default=1)
    args = parser.parse_args()

    import numpy as np
    import torch
    from skycomputing_tpu_torch.dataset import RandomTokenGenerator
    from skycomputing_tpu_torch.dynamics import ModelBenchmarker
    from skycomputing_tpu_torch.ops import _build
    from skycomputing_tpu_torch.ops.flash_attention import flash_attention
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_int8,
    )
    from skycomputing_tpu_torch.runner import SelfHealHook

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    for source in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        _build.build(source)
    kernels = {name: dict(fn=fn) for name, fn in (
        (cs.B1, flash_attention), (cs.B2, paged_attention),
        (cs.B3, paged_attention_int8))}
    bert_cfg, model_cfg = cs.bert_units()
    static = ModelBenchmarker(model_cfg, RandomTokenGenerator(
        cs.BERT_BATCH, cs.BERT_SEQ, bert_cfg.vocab_size))
    static.benchmark()

    hook_rows = []
    after_iter = SelfHealHook.after_iter

    def traced_after_iter(self, runner):
        started = self._started
        after_iter(self, runner)
        row = dict(iter=runner.iter, elapsed_s=(
            None if started is None else self._clock() - started),
            ewma_s=self._ewma, baseline_s=self._baseline,
            streak=self._streak, heals=self.heals)
        hook_rows.append(row)
        print(json.dumps(row), flush=True)

    SelfHealHook.after_iter = traced_after_iter
    failed = []

    def check(cond, msg):
        print(("   ok: " if cond else "   CHECK FAILED: ") + msg, flush=True)
        if not cond:
            failed.append(msg)

    cs.check = check
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    order = list(args.factors) + list(reversed(args.factors))
    runs = []
    for _ in range(args.reps):
        for factor in order:
            cs.HEAL_FACTOR = factor
            hook_rows.clear()
            failed.clear()
            print(f"== factor {factor}", flush=True)
            try:
                _, heal = cs.selfheal_path(torch, np, kernels, model_cfg,
                                           bert_cfg.vocab_size, static,
                                           out_dir)
                keep = ("heal_iter", "divergence", "partition_after",
                        "baseline_median_ms", "straggler_median_ms",
                        "post_heal_median_ms", "straggler_over_baseline")
                row = {key: heal[key] for key in keep}
            except Exception as exc:  # a run that does not heal is a row
                row = dict(error=f"{type(exc).__name__}: {exc}")
            row.update(factor=factor, checks_failed=list(failed),
                       hook=list(hook_rows))
            print(json.dumps({k: v for k, v in row.items() if k != "hook"}),
                  flush=True)
            runs.append(row)
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    (out_dir / "selfheal_ab.json").write_text(json.dumps(
        dict(card=card, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
