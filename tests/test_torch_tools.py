"""The port's other measuring commands on the CPU, against the JAX
package's ``tools/`` where both give the same figure: ``bench_kv_cache``
(identical tokens at a tiny GPT), ``bench_mfu`` (its FLOPs the profiling
counter's), ``profile_allocation`` (the same partitions as JAX's tool at
BERT ``tiny`` over one fixed device profile), ``run_ladder`` (the two
smallest rungs at ``tiny``, 2 iterations, as
``tests/test_ladder_smoke.py`` asks), and every device-bound command
raising without ``--device`` where there is no card."""

import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from skycomputing_tpu.dynamics import benchmarker as jax_benchmarker
from skycomputing_tpu_torch.builder import build_layer_stack
from skycomputing_tpu_torch.config import load_config
from skycomputing_tpu_torch.dynamics import benchmarker
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.tools import (
    bench_kv_cache,
    bench_mfu,
    bench_step_overhead,
    profile_allocation,
    run_ladder,
    validate_schedule_model,
)
from skycomputing_tpu_torch.utils.profiling import compiled_cost

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
PORT_CONFIG = str(REPO / "skycomputing_tpu_torch" / "configs"
                  / "bert_pipeline.py")
TINY = dict(SKYTPU_PRESET="tiny", SKYTPU_LAYER_NUM="2", SKYTPU_CORE_NUM="4",
            SKYTPU_BATCH_SIZE="4", SKYTPU_SEQ_LEN="16")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _json_line(text):
    return next(json.loads(x) for x in text.splitlines() if x.startswith("{"))


def test_bench_kv_cache_tokens_identical(monkeypatch, capsys):
    monkeypatch.setitem(bench_kv_cache.GPT, "vocab_size", 256)
    monkeypatch.setitem(bench_kv_cache.GPT, "hidden_size", 64)
    monkeypatch.setitem(bench_kv_cache.GPT, "num_hidden_layers", 2)
    monkeypatch.setitem(bench_kv_cache.GPT, "num_attention_heads", 2)
    monkeypatch.setitem(bench_kv_cache.GPT, "max_position_embeddings", 64)
    monkeypatch.setattr(bench_kv_cache, "PROMPT", (2, 8))
    monkeypatch.setenv("KV_TOKENS", "6")
    monkeypatch.setenv("KV_CTX", "32")
    assert bench_kv_cache.main(["--device", "cpu"]) == 0
    out = _json_line(capsys.readouterr().out)
    assert out["identical"] and out["new_tokens"] == 6
    assert out["cached_ms_per_token"] > 0 and out["full_ms_per_token"] > 0


def test_bench_mfu_counts_the_whole_step(monkeypatch, capsys):
    for key, value in dict(SKYTPU_MFU_PRESET="tiny", SKYTPU_MFU_BATCH="4",
                           SKYTPU_MFU_SEQ="16", SKYTPU_MFU_UNITS="2",
                           SKYTPU_MFU_ITERS="1").items():
        monkeypatch.setenv(key, value)
    assert bench_mfu.main(["--device", "cpu"]) == 0
    out = _json_line(capsys.readouterr().out)
    assert out["mfu"] is None  # no peak applies to the CPU
    assert out["units"] == 9 and out["dtype"] == "bfloat16"
    # the whole step, backward and update included: about 3x the forward
    units = bert_layer_configs(bert_config("tiny"), num_encoder_units=2,
                               num_classes=3, deterministic=True)
    ids = torch.zeros(4, 16, dtype=torch.int64)
    forward = compiled_cost(build_layer_stack(units), ids, ids, ids)["flops"]
    assert 2.5 < out["flops_per_step"] / forward < 3.5
    assert out["unit_flops"] > 0 and out["step_time_ms"] > 0
    monkeypatch.setenv("SKYTPU_PEAK_TFLOPS", "1")
    assert bench_mfu.peak_flops(torch.device("cpu")) == 1e12


FIXED_TIMES = [1.0, 3.0, 1.5, 2.0]


def _fixed_profile(self):
    return {f"worker{w.rank}": dict(time=FIXED_TIMES[w.rank % 4],
                                    avai_mem=1e5)
            for w in self._worker_manager.worker_pool}


def _jax_partitions(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_profile_allocation", REPO / "tools" / "profile_allocation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", [
        "profile_allocation", "-c", str(REPO / "experiment" / "config.py")])
    assert tool.main() == 0
    parts, current = {}, None
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("== ") and line.endswith(" partition =="):
            current = parts.setdefault(line.split()[1], [])
        elif current is not None and line.strip().startswith("stage"):
            current.append(int(line.split(")")[1].split()[0]))
        elif not line.strip():
            current = None
    return parts


def test_profile_allocation_partitions_equal_jax(monkeypatch, capsys,
                                                 tmp_path):
    for key, value in TINY.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("SKYTPU_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setattr(jax_benchmarker.DeviceBenchmarker, "benchmark",
                        _fixed_profile)
    monkeypatch.setattr(benchmarker.DeviceBenchmarker, "benchmark",
                        _fixed_profile)
    want = _jax_partitions(monkeypatch, capsys)
    out = tmp_path / "profile.json"
    assert profile_allocation.main(["-c", PORT_CONFIG, "--json", str(out),
                                    "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert set(want) == {"even", "dynamic", "optimal"}
    assert got["partitions"] == want
    assert got["profile"] == "flops" and got["flash_launches"] == {}
    assert len(got["units"]) == 9 and all(f > 0 for f in got["units"])


def test_run_ladder_two_smallest_rungs(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("SKYTPU_PRESET", "tiny")
    out_json = tmp_path / "ladder.json"
    rc = run_ladder.main(["--only", "even_4", "optimal_8", "--max-iters",
                          "2", "--timeout", "240", "--log-root",
                          str(tmp_path / "logs"), "--json", str(out_json),
                          "--device", "cpu"])
    assert rc == 0, capsys.readouterr().out
    record = json.loads(out_json.read_text())
    rungs = {r["config"]: r for r in record["rungs"]}
    assert set(rungs) == {"even_4", "optimal_8"}
    for r in rungs.values():
        assert r["exit"] == 0, r
        assert len(r["losses"]) == 2 and all(
            x is not None and math.isfinite(x) for x in r["losses"]), r
        # the plain versions on the CPU launch no kernel
        assert r["flash_launches"] == [{}, {}]
    # 8 stages covering every unit of the LAYER_NUM=10 model
    alloc = rungs["optimal_8"]["allocation"]
    assert len(alloc) == 8 and sum(alloc) == 33, alloc
    assert run_ladder.main(["--only", "no_such_rung", "--device",
                            "cpu"]) == 2


@pytest.mark.parametrize("switch", [None, "1"])
def test_kernel_launch_hook_only_under_its_switch(monkeypatch, switch):
    # run_ladder sets the switch for its rungs; other launcher runs keep
    # the config's hooks as they were
    if switch is None:
        monkeypatch.delenv("SKYTPU_KERNEL_LAUNCHES", raising=False)
    else:
        monkeypatch.setenv("SKYTPU_KERNEL_LAUNCHES", switch)
    hooks = [h["type"] for h in
             load_config(PORT_CONFIG).train_config["hook_config"]]
    assert ("KernelLaunchHook" in hooks) == (switch == "1"), hooks


@pytest.mark.parametrize("tool, argv", [
    (bench_step_overhead, []),
    (validate_schedule_model, []),
    (bench_kv_cache, []),
    (bench_mfu, []),
    (profile_allocation, ["-c", PORT_CONFIG]),
    (run_ladder, ["--only", "even_4"]),
], ids=lambda x: getattr(x, "__name__", "argv").split(".")[-1])
def test_each_command_raises_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
