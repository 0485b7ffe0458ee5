"""The plain float32 references against the port, at tiny widths on the
CPU (the kernels run their plain versions there)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.loops import serve_closed, train
from benchmark.harness import weights
from benchmark.reference import bert as ref_bert
from benchmark.reference import gpt as ref_gpt
from benchmark.tests.conftest import TINY_SERVE, TINY_TRAIN, tiny_files, \
    write_root


def _float32_root(tmp_path: Path) -> Path:
    files = tiny_files()
    for rel in ("benchmark/configs/tiny-bert.json",
                "benchmark/configs/tiny-gpt.json"):
        files[rel]["run"]["dtype"] = "float32"
    return write_root(tmp_path, files)


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bert_forward_matches_the_port():
    cfg = train.model_fields(tiny_files()["benchmark/configs/tiny-bert.json"])
    from skycomputing_tpu_torch.builder import build_layer_stack
    from skycomputing_tpu_torch.models import BertConfig, bert_layer_configs

    layer_cfgs = bert_layer_configs(
        BertConfig(**cfg, dtype="float32", use_flash_attention=True), 2,
        num_classes=3)
    units = weights.make(ref_bert.layout(cfg, 3), 5, "cpu", 0.02)
    stack = build_layer_stack(layer_cfgs)
    for module, sd in zip(stack.layers, units):
        module.load_state_dict(sd, strict=True)
    # the masks the port's dropout modules draw, by unit, for the
    # reference to apply at its own sites
    masks = {}
    for unit, module in enumerate(stack.layers):
        for m in module.modules():
            if isinstance(m, torch.nn.Dropout):
                m.register_forward_hook(
                    lambda mod, x, out, unit=unit:
                    masks.__setitem__(unit, out.ne(0)))
    traffic = tiny_files()[f"benchmark/traffic/{TINY_TRAIN}.json"]
    ids, types, mask, _, _ = (torch.from_numpy(a) for a in
                              train.make_batch(traffic, cfg, 3, 5, 0))
    torch.manual_seed(5)
    with torch.no_grad():
        got = stack(ids, types, mask)
        assert sorted(masks) == ref_bert.dropout_units(2)
        want = ref_bert.forward(units, cfg, ids, types, mask, masks=masks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_gpt_forward_matches_the_port():
    cfg = serve_closed.model_fields(
        tiny_files()["benchmark/configs/tiny-gpt.json"])
    from skycomputing_tpu_torch.models import GptConfig, gpt_layer_configs
    from skycomputing_tpu_torch.models.gpt import one_shot_forward

    layer_cfgs = gpt_layer_configs(GptConfig(**cfg, dtype="float32"),
                                   deterministic=True)
    units = weights.make(ref_gpt.layout(cfg), 6, "cpu", 0.02)
    ids = torch.randint(0, cfg["vocab_size"], (1, 40),
                        generator=torch.Generator().manual_seed(0))
    got = one_shot_forward(layer_cfgs, units, "cpu")(ids)[0]
    want = ref_gpt.forward(units, cfg, ids[0])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell,bound", [(TINY_TRAIN, 1e-4),
                                        (TINY_SERVE, 1e-4)])
def test_float32_program_agrees_with_the_reference(tmp_path, capsys, cell,
                                                   bound):
    """With the program in float32, the harness's own comparison (loss,
    gradient and update gaps; the served tokens' logit gap) reads
    round-off only."""
    rc = run.main(["--workload", cell, "--seed", "2147483701",
                   "--seconds", "1"], root=_float32_root(tmp_path),
                  device="cpu")
    assert rc == 0
    line = _last_line(capsys)
    assert line["checks"]
    for name, item in line["checks"].items():
        assert item["value"] <= bound, (name, item)
