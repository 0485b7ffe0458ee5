"""The control of ``correct``: the reference computed in fp8 (both operands
of every product rounded to float8 e4m3 under a per-tensor scale), put in
the program's place at each cell's own size, has to come out not
correct under the cell's limits.  At the sizes a CPU test can hold the
fp8 error stays under the full-size limits, so these run on the card:
``python -m pytest benchmark/tests/test_benchmark_control.py -m cuda``
(they skip here)."""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

from benchmark.loops import serve_closed, train
from benchmark.harness import checks, spec, traffic, weights
from benchmark.reference import bert as ref_bert
from benchmark.reference import gpt as ref_gpt
from benchmark.reference.precision import float32_exact
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: spec.load_cell(w["name"]) for w in BENCH["workloads"]}
TRAIN = [n for n, c in CELLS.items() if c["traffic"]["loop"] == "train"]
SERVE = [n for n, c in CELLS.items()
         if c["traffic"]["loop"] == "serve_closed"]
SEED = 2147483661
#: the training control's seeds: drawn afresh in every session, so that
#: no seed is picked for the control failing on it
TRAIN_SEEDS = tuple(random.SystemRandom().randrange(2 ** 31)
                    for _ in range(3))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", range(len(TRAIN_SEEDS)))
@pytest.mark.parametrize("name", TRAIN)
def test_training_control_is_not_correct(name, draw):
    """Over the cell's weights, batches and dropout masks (drawn from a
    fresh seed), the fp8 reference against the float32 one."""
    device = _card()
    seed = TRAIN_SEEDS[draw]
    cell = CELLS[name]
    cfg, run_cfg, tr = (train.model_fields(cell["config"]),
                        cell["config"]["run"], cell["traffic"])
    with float32_exact():
        units = weights.make(ref_bert.layout(cfg, run_cfg["num_classes"]),
                             seed, device, cfg["initializer_range"])
        batches = [tuple(torch.from_numpy(a).to(device)
                         for a in train.make_batch(
                             tr, cfg, run_cfg["num_classes"], seed, i)[:4])
                   for i in range(int(tr["check_steps"]))]
        rows = int(tr["check"]["block_rows"])
        masks = ref_bert.draw_masks(cfg, int(tr["batch"]), int(tr["seq"]),
                                    len(batches), seed, device)
        ref = ref_bert.train(units, cfg, batches, run_cfg["lr"], rows,
                             masks=masks)
        low = ref_bert.train(units, cfg, batches, run_cfg["lr"], rows,
                             quant="fp8", masks=masks)
    found = checks.train_numbers(low, ref)
    correct, items = checks.judge(found["numbers"], tr["check"]["limits"])
    assert not correct, (seed, items)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE)
def test_serving_control_is_not_correct(name):
    """Teacher-forced over prompts and continuations drawn as the cell
    draws them: the widest float32 gap of the tokens that the fp8
    forward puts first."""
    device = _card()
    cell = CELLS[name]
    cfg, tr = serve_closed.model_fields(cell["config"]), cell["traffic"]
    pool = traffic.size_pool(tr["sizes"])
    order = traffic.order(len(pool), SEED)
    rng = np.random.default_rng(SEED)
    with float32_exact():
        units = weights.make(ref_gpt.layout(cfg), SEED, device,
                             cfg["initializer_range"])
        gaps, served = [], 0
        for i in order:
            if served >= int(tr["check"]["served_tokens"]):
                break
            prompt_len, out_len = (int(x) for x in pool[i])
            ids = torch.from_numpy(rng.integers(
                0, cfg["vocab_size"], prompt_len + out_len)).to(device)
            found = ref_gpt.served_gaps(units, cfg, ids[:prompt_len],
                                        ids[prompt_len:], control="fp8")
            gaps.append(found["control_gap"])
            served += out_len
    correct, items = checks.judge(dict(logit_gap=max(gaps)),
                                  tr["check"]["limits"])
    assert not correct, items
