#!/usr/bin/env python
"""What the launcher's step costs over the GPipe phase's, by cause, on
one NVIDIA GPU.

``chip_smoke.py``'s launcher phase (``launch.run`` on
``skycomputing_tpu_torch/configs/bert_pipeline.py``: BERT-large, 24
layers, flash on, hidden dropout 0.1, padded rows, ``optimal``, 1F1B
M=4) steps slower than its GPipe phase (dropout 0, unpadded rows, even
split, GPipe M=4).  This script runs the launcher itself with each of
the three differences set either way — hidden dropout 0 or 0.1; rows
unpadded (``chip_smoke.bert_batch``'s 32 rows, cycled: ids in [5,
vocab), token types 0, every key live) or padded (the config's
``GlueDataset``, its synthetic MNLI corpus of lengths 8-128); ``even``
or ``optimal`` (static profile, stimulated workers) — under 1F1B M=4, and once more as the GPipe phase
runs (GPipe, even, dropout 0, unpadded), all in one process.  Each run
takes 5 steps of batch 32 at seq 128; its step time is the median of
steps 2-5 of ``PipelineStats``.  The runs go in order, then in reverse,
``--reps`` times.

Prints one JSON object per run and a summary (each variant's mean,
minimum, median and interquartile range; each cause's effect in every
pair of variants that differ in it alone), and writes them to
``chiprun_out/launcher_ab.json``.  Usage::

    python3 launcher_ab.py [--reps 1] [--layers 24] [--preset large]
        [--device cpu]
    python3 launcher_ab.py --summarize chiprun_out/launcher_ab.json
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from skycomputing_tpu_torch.registry import DATASET  # noqa: E402

VARIANTS = [
    dict(schedule="1f1b", allocate=a, dropout=d, padded=p)
    for a, d, p in itertools.product(("even", "optimal"), (0.0, 0.1),
                                     (False, True))
] + [dict(schedule="gpipe", allocate="even", dropout=0.0, padded=False)]


class GpipePhaseRows:
    """The GPipe phase's rows (``chip_smoke.bert_batch``: ids in [5,
    vocab) from a seed, token types 0, every key live), cycled to
    ``num_samples``, in the loader's ``(ids, mask, segment_ids)`` order."""

    def __init__(self, num_samples, vocab_size):
        (self.ids, self.segs, self.mask), self.labels = cs.bert_batch(
            np, vocab_size)
        self.num_samples = num_samples

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        j = i % len(self.ids)
        return (self.ids[j], self.mask[j], self.segs[j]), int(self.labels[j])


DATASET.register_module(GpipePhaseRows)


def run_variant(torch, variant, layers, preset, device):
    from skycomputing_tpu_torch import launch
    from skycomputing_tpu_torch.config import load_config
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.runner import Hook
    from skycomputing_tpu_torch.utils import Logger

    workdir = ROOT / "build" / "launcher_ab"
    env = dict(cs.launcher_env(workdir, preset, layers), SKYTPU_CKPT_DIR="",
               SKYTPU_SCHEDULE=variant["schedule"],
               SKYTPU_ALLOCATE_TYPE=variant["allocate"])
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config(str(
            ROOT / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    bert = bert_config(preset, hidden_dropout_prob=variant["dropout"],
                       attention_probs_dropout_prob=0.0,
                       use_flash_attention=True)
    cfg.model_config = bert_layer_configs(
        bert, num_encoder_units=layers, num_classes=3,
        deterministic=variant["dropout"] == 0.0)
    if not variant["padded"]:
        cfg.data_config = dict(
            dataset_cfg=dict(type="GpipePhaseRows",
                             num_samples=cs.BERT_BATCH * cs.BERT_STEPS,
                             vocab_size=bert.vocab_size),
            dataloader_cfg=dict(batch_size=cs.BERT_BATCH, shuffle=True))

    class Record(Hook):
        def __init__(self):
            self.steps = []

        def after_train_iter(self, runner):
            self.steps.append(runner.model.stats.snapshot())

    record = Record()
    t0 = time.perf_counter()
    out = launch.run(cfg, Logger(**cfg.logging_config), device=device,
                     hooks=[record])
    wall = time.perf_counter() - t0
    steps = [s["forward_s"] + s["backward_s"] + s["step_s"]
             for s in record.steps]
    row = dict(variant, step_s=steps,
               step_s_median_2_5=float(np.median(steps[1:])),
               dispatch_s_median_2_5=float(np.median(
                   [s["dispatch_s"] for s in record.steps[1:]])),
               partition=out.model.partition_signature(), wall_s=wall,
               losses=[s["loss"] for s in record.steps])
    del out
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def _key(variant):
    return (f"{variant['schedule']}/{variant['allocate']}/dropout "
            f"{variant['dropout']}/"
            f"{'padded' if variant['padded'] else 'unpadded'}")


# each cause: the variant key it changes, and the value it changes to
CAUSES = dict(dropout=("dropout", 0.1), padding=("padded", True),
              optimal=("allocate", "optimal"), gpipe=("schedule", "gpipe"))


def summarize(rows):
    """Per variant: the mean, minimum, median and interquartile range of
    its runs' step times.  Per cause: for each pair of variants that
    differ in it alone, the change of the mean step it brings, beside
    the two variants' interquartile ranges relative to their medians."""
    summary = {}
    for variant in VARIANTS:
        times = [r["step_s_median_2_5"] for r in rows
                 if all(r[k] == v for k, v in variant.items())]
        q1, med, q3 = (float(x) for x in np.percentile(times, [25, 50, 75]))
        summary[_key(variant)] = dict(
            mean_s=float(np.mean(times)), min_s=float(np.min(times)),
            median_s=med, iqr_s=q3 - q1, iqr_rel=(q3 - q1) / med, runs=times)
    effects = {}
    for cause, (field, value) in CAUSES.items():
        pairs = []
        for variant in VARIANTS:
            if variant[field] != value:
                continue
            base = dict(variant)
            base[field] = next(v[field] for v in VARIANTS
                               if v[field] != value)
            if base not in VARIANTS:
                continue
            on, off = summary[_key(variant)], summary[_key(base)]
            pairs.append(dict(
                pair=f"{_key(base)} -> {_key(variant)}",
                effect=on["mean_s"] / off["mean_s"] - 1.0,
                iqr_rel=[off["iqr_rel"], on["iqr_rel"]]))
        effects[cause] = dict(
            pairs=pairs,
            mean_effect=float(np.mean([p["effect"] for p in pairs])),
            positive=sum(p["effect"] > 0 for p in pairs))
    return summary, effects


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=1)
    parser.add_argument("--layers", type=int, default=24)
    parser.add_argument("--preset", default="large")
    parser.add_argument("--device",
                        help="run here (e.g. cpu) instead of on the card")
    parser.add_argument("--summarize", metavar="JSON",
                        help="summarize the rows of an earlier run's "
                        "launcher_ab.json instead of running")
    args = parser.parse_args()
    if args.summarize:
        earlier = json.loads(Path(args.summarize).read_text())
        summary, effects = summarize(earlier["rows"])
        print(json.dumps(dict(card=earlier["card"], summary=summary,
                              effects=effects), indent=1))
        return 0
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to rehearse",
              file=sys.stderr)
        return 2
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if args.device is None else "cpu"
    rows = []
    for rep in range(args.reps):
        for variant in VARIANTS + VARIANTS[::-1]:
            row = run_variant(torch, variant, args.layers, args.preset,
                              args.device)
            row.update(rep=rep, card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary, effects = summarize(rows)
    print(json.dumps(dict(card=card, summary=summary, effects=effects)),
          flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "launcher_ab.json").write_text(json.dumps(
        dict(card=card, rows=rows, summary=summary, effects=effects),
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
