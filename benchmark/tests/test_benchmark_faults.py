"""A whole run, past the look for a card, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have, and true for the sound run.  Every cell runs on one card, so no
cell has an exchange between cards to leave out."""

from __future__ import annotations

import json

import pytest

from benchmark import run
from benchmark.tests.conftest import TINY_SERVE, TINY_TRAIN


def _run(root, cell, capsys, seed=2147483999):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1"],
                  root=root, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [TINY_TRAIN, TINY_SERVE])
def test_sound_run_is_correct(tiny_root, capsys, cell):
    line = _run(tiny_root, cell, capsys)
    assert line["correct"], line["checks"]


def _frozen_state(monkeypatch):
    """A step that returns its state unchanged: the update is dropped."""
    from skycomputing_tpu_torch.parallel.pipeline import StageRuntime

    monkeypatch.setattr(
        StageRuntime, "apply_gradients",
        lambda self: self.optimizer.zero_grad(set_to_none=True))


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from skycomputing_tpu_torch.parallel.pipeline import PipelineModel

    step = PipelineModel.train_step

    def half(self, data, labels, generator=None):
        n = labels.shape[0] // 2
        return step(self, tuple(x[:n] for x in data), labels[:n], generator)

    monkeypatch.setattr(PipelineModel, "train_step", half)


def _altered_token(monkeypatch):
    """A served token altered where it is produced."""
    from skycomputing_tpu_torch.serving.engine import ServingEngine

    pick = ServingEngine._pick_token

    def altered(self, request, greedy_tok, logits_row):
        tok = pick(self, request, greedy_tok, logits_row)
        if len(request.tokens) == 3:
            return (tok + 1) % self.stages[-1].modules[-1].config.vocab_size
        return tok

    monkeypatch.setattr(ServingEngine, "_pick_token", altered)


@pytest.mark.parametrize("cell,fault", [
    (TINY_TRAIN, _frozen_state),
    (TINY_TRAIN, _half_batch),
    (TINY_SERVE, _altered_token),
], ids=["frozen_state", "half_batch", "altered_token"])
def test_a_broken_path_is_not_correct(tiny_root, capsys, monkeypatch, cell,
                                      fault):
    fault(monkeypatch)
    line = _run(tiny_root, cell, capsys)
    assert not line["correct"], line["checks"]
    assert any(item["value"] is None or item["value"] > item["limit"]
               for item in line["checks"].values())
