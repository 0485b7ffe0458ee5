"""Fixtures of the benchmark's CPU tests: a tiny checkout root whose
``BENCHMARK.json`` holds one training and one serving cell at tiny
widths, with the real cells' loop kinds, traffic shapes and limits."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRAIN_CELL, SERVE_CELL = "bert-large.s128-b256", "gpt2-xl.chat-c128"
TINY_TRAIN, TINY_SERVE = "tiny-bert.t", "tiny-gpt.t"


def _load(rel):
    return json.loads((ROOT / rel).read_text())


def tiny_files():
    """{relative path: JSON object} of the tiny root."""
    bench = _load("BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}

    bert = _load(configs["bert-large"]["file"])
    bert.update(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=256,
                max_position_embeddings=128)
    bert["run"]["microbatches"] = 2
    gpt = _load(configs["gpt2-xl"]["file"])
    gpt.update(vocab_size=512, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=256,
               max_position_embeddings=128)

    train = _load(f"benchmark/traffic/{cells[TRAIN_CELL]['traffic']}.json")
    train.update(batch=8, seq=32, slice_seconds=0.5)
    train["lengths"].update(median=12, min=4, max=32)
    train["check"]["block_rows"] = 4
    serve = _load(f"benchmark/traffic/{cells[SERVE_CELL]['traffic']}.json")
    serve.update(clients=4, warm_completions=4, slice_seconds=0.5)
    serve["sizes"].update(pool=64, max_total=128)
    serve["sizes"]["prompt"].update(median=24, min=8, max=64)
    serve["sizes"]["output"].update(median=12, min=4, max=32)
    serve["engine"].update(num_pages=32, buckets=[32, 64, 128],
                           prefill_batch=2)
    serve["check"]["served_tokens"] = 32

    tiny = copy.deepcopy(bench)
    tiny["configs"] = [
        dict(configs["bert-large"], name="tiny-bert",
             file="benchmark/configs/tiny-bert.json"),
        dict(configs["gpt2-xl"], name="tiny-gpt",
             file="benchmark/configs/tiny-gpt.json")]
    tiny["workloads"] = [
        dict(cells[TRAIN_CELL], name=TINY_TRAIN, config="tiny-bert",
             traffic=TINY_TRAIN),
        dict(cells[SERVE_CELL], name=TINY_SERVE, config="tiny-gpt",
             traffic=TINY_SERVE)]
    rename = {TRAIN_CELL: TINY_TRAIN, SERVE_CELL: TINY_SERVE}
    for m in tiny["end_to_end"] + tiny["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]
                              if w in rename]
    return {
        "BENCHMARK.json": tiny,
        "benchmark/configs/tiny-bert.json": bert,
        "benchmark/configs/tiny-gpt.json": gpt,
        f"benchmark/traffic/{TINY_TRAIN}.json": train,
        f"benchmark/traffic/{TINY_SERVE}.json": serve,
    }


def write_root(path: Path, files=None) -> Path:
    for rel, obj in (files or tiny_files()).items():
        target = path / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(json.dumps(obj, indent=1))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
