"""``python -m skycomputing_tpu_torch.tools.bench_step_overhead`` against
the JAX package's ``tools/bench_step_overhead.py``: both modes at
STEPS=2, ROUNDS=1 (set through the module), their JSON keys JAX's less
the ones the port names as having no counterpart, and the mesh
equivalence leg bitwise."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from skycomputing_tpu_torch.tools import bench_step_overhead as bso

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# JAX's keys that have no counterpart in the port (the tool's docstring)
NO_COUNTERPART = {"transfers", "transfers_elided", "compiles"}
MESH_NO_COUNTERPART = {"programs_per_step", "puts_per_step"}
MESH_PORT_ONLY = {"ops_per_step", "kernels_per_step"}


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setattr(bso, "STEPS", 2)
    monkeypatch.setattr(bso, "ROUNDS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_keys(monkeypatch):
    """JAX's sample and tracing keys, from its own functions over a
    stand-in model (no JAX pipeline is built)."""
    monkeypatch.setenv("SKYTPU_BENCH_OVERHEAD_REEXEC", "1")
    spec = importlib.util.spec_from_file_location(
        "jax_bench_step_overhead", REPO / "tools" / "bench_step_overhead.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(jax_tool, "STEPS", 2)
    monkeypatch.setattr(jax_tool, "ROUNDS", 1)

    class Model:
        stats = SimpleNamespace(dispatch_s=0.0, compute_wait_s=0.0,
                                transfers=0, transfers_elided=0, compiles=0)

        def train_step(self, data, labels, rng=None):
            return float(sum(range(1000)))  # a step that takes some time

    sample = jax_tool._sample(Model(), None, None, 0)
    tracing = jax_tool._trace_overhead(Model(), None, None)
    return set(sample), set(tracing)


def test_default_mode_keys_equal_jax(monkeypatch):
    sample_keys, tracing_keys = _jax_keys(monkeypatch)
    out = bso.run_default(CPU)
    assert {"steps", "rounds", "schedules", "tracing"} <= set(out)
    assert out["steps"] == 2 and out["rounds"] == 1
    assert set(out["schedules"]) == {"gpipe", "1f1b"}
    for schedule, by_mode in out["schedules"].items():
        # one dispatch path: its figures under JAX's "hotpath"
        assert set(by_mode) == {"hotpath"}
        agg = by_mode["hotpath"]
        assert set(agg) - {"dispatch_fraction"} == sample_keys - NO_COUNTERPART
        assert 0.0 < agg["dispatch_s"] <= agg["step_wall_s"]
        assert 0.0 < agg["dispatch_fraction"] <= 1.0
    assert set(out["tracing"]) == tracing_keys
    assert out["tracing"]["events_per_step"] > 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}


def test_traced_window_reads_back(tmp_path):
    from skycomputing_tpu_torch.telemetry.analysis import analyze

    path = tmp_path / "window.json"
    bso.run_default(CPU, trace=False, trace_out=str(path))
    report = analyze(json.loads(path.read_text())["traceEvents"])
    assert report["steps"]["count"] == 3 and report["num_stages"] == 4
    assert report["dispatch"]["steps"] == 3


def test_mesh_mode_keys_and_bitwise_equivalence(tmp_path, capsys):
    out_path = tmp_path / "mesh.json"
    rc = bso.main(["--mesh", "--out", str(out_path), "--device", "cpu"])
    out = json.loads(out_path.read_text())
    gates = out["gates"]
    assert rc == (0 if all(g["ok"] for g in gates.values()) else 1)
    # the equivalence leg: mesh against per-device, bit for bit
    assert out["equivalence"] == {
        f"{what}_{schedule}": True for schedule in ("gpipe", "1f1b")
        for what in ("bitwise_equal", "losses_equal")}
    assert gates["params_bitwise_equal"]["ok"]
    jax_out = json.loads((REPO / "BENCH_mesh_pipeline.json").read_text())
    assert set(jax_out) <= set(out)
    assert set(out["gates"]) == set(jax_out["gates"])
    assert set(out["equivalence"]) == set(jax_out["equivalence"])
    for mode, jax_mode in jax_out["modes"].items():
        got = set(out["modes"][mode])
        assert got == (set(jax_mode) - MESH_NO_COUNTERPART) | MESH_PORT_ONLY
        assert out["modes"][mode]["kernels_per_step"] is None  # no card
    assert out["modes"]["mesh"]["chips_per_stage"] == [1, 1, 1, 1]
    assert out["modes"]["mesh_multichip"]["chips_per_stage"] == [2, 2, 2, 2]
    assert out["modes"]["per_device"]["stages"] == 8
    assert "GATE FAILED" in capsys.readouterr().err or rc == 0
