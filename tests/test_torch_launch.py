"""The launcher's main path on the CPU at BERT ``tiny``, depth 2: load
the port's config -> profile -> allocate -> build the pipeline -> train
with the config's hooks, to finite losses, under each allocation type
and schedule; no fallback to the CPU without ``--device``; a failed
allocation ends the run without training.  The headline pass's command
line at the same size."""

import json

import numpy as np
import pytest
import torch

from skycomputing_tpu_torch import launch
from skycomputing_tpu_torch.dynamics import headline
from skycomputing_tpu_torch.config import load_config
from skycomputing_tpu_torch.runner import CheckpointHook, Hook, StopHook
from skycomputing_tpu_torch.utils import Logger

pytestmark = pytest.mark.torch_port

CONFIG = "skycomputing_tpu_torch/configs/bert_pipeline.py"


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def after_train_iter(self, runner):
        self.losses.append(runner.model.stats.loss)


@pytest.fixture
def tiny_env(monkeypatch, tmp_path):
    for key, value in dict(SKYTPU_PRESET="tiny", SKYTPU_LAYER_NUM="2",
                           SKYTPU_BATCH_SIZE="8", SKYTPU_SEQ_LEN="32",
                           SKYTPU_MAX_ITERS="3", SKYTPU_FLASH="1",
                           SKYTPU_LOG_ROOT=str(tmp_path / "logs"),
                           SKYTPU_CKPT_DIR=str(tmp_path / "ckpt"),
                           STIMULATE="1").items():
        monkeypatch.setenv(key, value)
    monkeypatch.chdir(launch.__file__.rsplit("/", 2)[0])
    return tmp_path


@pytest.mark.parametrize("allocate,schedule,profile", [
    ("optimal", "1f1b", "static"),
    ("dynamic", "gpipe", "timed"),
    ("even", "gpipe", "static"),
])
def test_launcher_trains_to_finite_losses(tiny_env, monkeypatch, allocate,
                                          schedule, profile):
    monkeypatch.setenv("SKYTPU_ALLOCATE_TYPE", allocate)
    monkeypatch.setenv("SKYTPU_SCHEDULE", schedule)
    monkeypatch.setenv("SKYTPU_MICROBATCHES", "2")
    monkeypatch.setenv("SKYTPU_PROFILE", profile)
    cfg = load_config(CONFIG)
    assert len(cfg.model_config) == 1 + 3 * 2 + 2
    record = _Losses()
    out = launch.run(cfg, Logger(), device="cpu", hooks=[record])
    assert len(record.losses) == 3
    assert all(np.isfinite(x) for x in record.losses)
    assert out.model.schedule == schedule
    assert out.model.stats.interleaved == (schedule == "1f1b")
    sizes = [len(w.model_config) for w in
             sorted(out.worker_manager.worker_pool, key=lambda w: w.rank)]
    assert sum(sizes) == 9 and out.model.partition_signature() == [
        n for n in sizes if n]
    if allocate == "optimal":
        result = out.allocator.last_result
        assert [b - a for a, b in result.slices] == [n for n in sizes if n]
        assert result.optimality_gap <= 1e-3
    if allocate == "even":
        assert sizes == [3, 2, 2, 2]
    else:
        assert out.model_benchmarker.distinct_units == 6
    hooks = {type(h): h for h in out.runner.hooks}
    assert StopHook in hooks
    # one epoch covers the 3 iterations: the epoch's checkpoint
    assert hooks[CheckpointHook].last_saved == str(tiny_env / "ckpt"
                                                   / "epoch_1.pt")
    # SKYTPU_FLASH: every attention unit takes the flash path (its plain
    # version on the CPU)
    heads = [m for stage in out.model.stages for m in stage.stack.layers
             if type(m).__name__ == "BertLayer_Head"]
    assert len(heads) == 2 and all(h.self.uses_flash(32) for h in heads)


def test_launcher_main_runs_the_cli(tiny_env):
    assert launch.main(["-c", CONFIG, "--allocate-type", "optimal",
                        "--device", "cpu"]) == 0
    log = tiny_env / "logs" / "4nodes_2layers" / "optimal" / "allocation.log"
    text = log.read_text()
    assert "solver path native_exact" in text
    assert "training complete" in text


def test_launcher_without_a_card_refuses_cpu_fallback(tiny_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["-c", CONFIG])


def test_failed_allocation_trains_nothing(tiny_env):
    cfg = load_config(CONFIG)
    cfg.allocator_config["type"] = "vibes"
    assert launch.run(cfg, Logger(), device="cpu") is None
    # memory no worker can hold: the solver's infeasible instance
    cfg = load_config(CONFIG)
    cfg.allocator_config["type"] = "optimal"
    for worker in cfg.worker_config:
        worker["extra_config"]["mem_limit"] = 1e-3
    assert launch.run(cfg, Logger(), device="cpu") is None


def test_headline_pass_cli_on_the_cpu(capsys):
    """The headline pass (even, group fit, optimal, optimal, even) at BERT
    ``tiny``, depth 2, under the paper's slowdowns."""
    assert headline.main(["--passes", "1", "--device", "cpu", "--preset",
                          "tiny", "--layers", "2", "--batch", "2", "--seq",
                          "8", "--repeats", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out, summary = json.loads(lines[-2]), json.loads(lines[-1])
    assert summary["passes"] == 1 and set(summary["optimal_below_even"]) \
        == {"4", "16"}
    assert out["even"]["partition"] == out["even_again"]["partition"] \
        == [3, 2, 2, 2]
    assert sum(out["optimal"]["partition"]) == 9
    assert out["optimal"]["partition"] == out["optimal_again"]["partition"]
    assert out["worker_slowdowns"] == [3.0, 5.0, 3.0, 6.0]
    assert set(out["group_scales"]) == {"first", "stack", "last"}
    assert 0.0 <= out["solver_gap"] < 1.0  # certified, device order searched
    for side in ("even", "optimal"):
        for m in ("4", "16"):
            a, b = (out[side]["step_s"][m],
                    out[f"{side}_again"]["step_s"][m])
            assert out[f"{side}_step_s"][m] == pytest.approx((a + b) / 2)
            assert a > 0 and b > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            headline.main(["--passes", "1", "--preset", "tiny", "--layers",
                           "2", "--batch", "2", "--seq", "8"])
