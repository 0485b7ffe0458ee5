"""The seeded traffic of every cell: the same seed gives the same trace,
another seed another, and every drawn length stays in its cell's
range."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.loops import train
from benchmark.harness import traffic
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}
CELLS = [(w["name"], CONFIGS[w["config"]],
          json.loads((ROOT / "benchmark" / "traffic"
                      / f"{w['traffic']}.json").read_text()))
         for w in BENCH["workloads"]]
TRAIN = [c for c in CELLS if c[2]["loop"] == "train"]
SERVE = [c for c in CELLS if c[2]["loop"] == "serve_closed"]
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("name,config,tr", TRAIN, ids=[c[0] for c in TRAIN])
def test_training_batches(name, config, tr):
    cfg = train.model_fields(config)
    classes = config["run"]["num_classes"]

    def digest(seed, index):
        return traffic.digest(*train.make_batch(tr, cfg, classes, seed,
                                                index))

    assert digest(BIG, 0) == digest(BIG, 0)
    assert digest(BIG, 0) != digest(BIG + 1, 0)
    assert digest(BIG, 0) != digest(BIG, 1)
    ids, types, mask, labels, lengths = train.make_batch(tr, cfg, classes,
                                                         BIG, 3)
    assert ids.shape == (tr["batch"], tr["seq"])
    assert lengths.min() >= tr["lengths"]["min"]
    assert lengths.max() <= min(tr["lengths"]["max"], tr["seq"])
    assert (mask.sum(1) == lengths).all()
    assert ids.max() < cfg["vocab_size"] and labels.max() < classes
    assert ((types == 1) <= (mask == 1)).all()


@pytest.mark.parametrize("name,config,tr", SERVE, ids=[c[0] for c in SERVE])
def test_serving_sizes(name, config, tr):
    sizes = tr["sizes"]
    pool = traffic.size_pool(sizes)
    assert traffic.digest(pool) == traffic.digest(traffic.size_pool(sizes))
    # every seed serves the same multiset, in its own order
    a, b = traffic.order(len(pool), BIG), traffic.order(len(pool), BIG + 1)
    assert traffic.digest(a) == traffic.digest(traffic.order(len(pool), BIG))
    assert traffic.digest(a) != traffic.digest(b)
    assert sorted(a) == sorted(b)
    prompt, output = pool[:, 0], pool[:, 1]
    assert prompt.min() >= sizes["prompt"]["min"]
    assert prompt.max() <= sizes["prompt"]["max"]
    assert output.min() >= 1
    assert output.max() <= sizes["output"]["max"]
    assert (prompt + output).max() <= sizes["max_total"]
    assert sizes["max_total"] <= config["max_position_embeddings"]
    # every request fits the decode rows' page footprint
    pages = -(-(prompt + output) // config["run"]["page_size"])
    assert pages.max() * tr["clients"] <= tr["engine"]["num_pages"]


def test_draws_stay_in_range():
    rng = np.random.default_rng(0)
    for spec in ({"dist": "lognormal", "median": 40, "sigma": 2.0,
                  "min": 16, "max": 128},
                 {"dist": "uniform", "min": 4, "max": 16}):
        x = traffic.draw(spec, 10000, rng)
        assert x.min() == spec["min"] and x.max() == spec["max"]
