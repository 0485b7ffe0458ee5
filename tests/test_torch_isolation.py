"""The port stands alone: no module of ``skycomputing_tpu_torch`` (the
serving bench, the workload mixes, the tuning loop and the static
analysers among them) and nothing in
``chip_smoke.py`` or ``prefill_ab.py`` imports ``jax``, ``flax`` or the
JAX package; the package imports with those blocked; an engine, a
pipeline or the serving bench asked for no device refuses to fall back
to the CPU; and ``chip_smoke.py`` fails without a CUDA device, also
when it stands alone in a directory."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "skycomputing_tpu")


def _port_files():
    files = sorted((ROOT / "skycomputing_tpu_torch").rglob("*.py"))
    return files + [ROOT / name for name in (
        "chip_smoke.py", "prefill_ab.py", "launcher_ab.py")]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKED_IMPORT = """
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import skycomputing_tpu_torch as pkg
for mod in pkg_mods(pkg):
    importlib.import_module(mod)
print("imported", len(sys.modules))
"""


def test_package_imports_with_jax_blocked():
    script = _BLOCKED_IMPORT.replace(
        "pkg_mods(pkg)",
        "[m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'skycomputing_tpu_torch.')]",
    ).format(blocked=set(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


@pytest.mark.parametrize("first", ["parallel", "runner", "analysis",
                                   "parallel.spmd_gpt",
                                   "parallel.tensor_parallel",
                                   "parallel.expert_parallel",
                                   "fleet", "telemetry.incidents",
                                   "tools.bench_fleet",
                                   "tools.skyreport", "tuning",
                                   "runner.hooks_collection.autotune_hook",
                                   "tools.bench_autotune",
                                   "tools.bench_flight", "tools.skylint",
                                   "tools.skyaudit", "tools.skydet"])
def test_each_subpackage_imports_first(first):
    """A user may import any subpackage before the others (the parallel
    engines' entry points are ``skycomputing_tpu_torch.parallel``): no
    import cycle breaks a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", f"import skycomputing_tpu_torch.{first}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_engine_without_device_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from skycomputing_tpu_torch.models.gpt import (
        GptConfig,
        gpt_layer_configs,
        random_state_dicts,
    )
    from skycomputing_tpu_torch.serving import ServingEngine

    cfg = GptConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                    num_attention_heads=2, max_position_embeddings=32,
                    dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(layer_cfgs, random_state_dicts(layer_cfgs, 0),
                      max_len=32, buckets=(8,), kv_layout="paged")


def test_bench_and_workload_are_covered():
    """The serving bench and the workload plane's modules are among the
    files the import check reads, and the bench's module imports nothing
    of the JAX package's ``tools/`` or ``workload/``."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"skycomputing_tpu_torch/bench_serving.py",
            "skycomputing_tpu_torch/workload/__init__.py",
            "skycomputing_tpu_torch/workload/mixes.py"} <= files
    roots = set(_imported_roots(ROOT / "skycomputing_tpu_torch"
                                / "bench_serving.py"))
    assert "tools" not in roots and "workload" not in roots


FLEET_PLANE = [
    "skycomputing_tpu_torch/fleet/__init__.py",
    "skycomputing_tpu_torch/fleet/admission.py",
    "skycomputing_tpu_torch/fleet/autoscaler.py",
    "skycomputing_tpu_torch/fleet/fleet.py",
    "skycomputing_tpu_torch/fleet/replica.py",
    "skycomputing_tpu_torch/fleet/router.py",
    "skycomputing_tpu_torch/fleet/supervisor.py",
    "skycomputing_tpu_torch/telemetry/exporter.py",
    "skycomputing_tpu_torch/telemetry/flight.py",
    "skycomputing_tpu_torch/telemetry/incidents.py",
    "skycomputing_tpu_torch/telemetry/slo.py",
    "skycomputing_tpu_torch/tools/bench_fleet.py",
    "skycomputing_tpu_torch/tools/skyreport.py",
    "skycomputing_tpu_torch/utils/retry.py",
]


@pytest.mark.parametrize("name", FLEET_PLANE)
def test_fleet_plane_is_covered(name):
    """The fleet plane's modules are among the files the import check
    reads, and none imports the JAX package's ``tools/``."""
    assert name in {str(p.relative_to(ROOT)) for p in _port_files()}
    assert "tools" not in set(_imported_roots(ROOT / name))


TUNING_AND_ANALYSIS = [
    "skycomputing_tpu_torch/tuning/__init__.py",
    "skycomputing_tpu_torch/tuning/advisor.py",
    "skycomputing_tpu_torch/tuning/autotune.py",
    "skycomputing_tpu_torch/runner/hooks_collection/autotune_hook.py",
    "skycomputing_tpu_torch/analysis/lint.py",
    "skycomputing_tpu_torch/analysis/audit.py",
    "skycomputing_tpu_torch/analysis/determinism.py",
    "skycomputing_tpu_torch/tools/bench_autotune.py",
    "skycomputing_tpu_torch/tools/bench_flight.py",
    "skycomputing_tpu_torch/tools/trace_report.py",
    "skycomputing_tpu_torch/tools/skylint.py",
    "skycomputing_tpu_torch/tools/skyaudit.py",
    "skycomputing_tpu_torch/tools/skydet.py",
    "skycomputing_tpu_torch/tools/changed.py",
    "skycomputing_tpu_torch/tools/_static_cli.py",
]


@pytest.mark.parametrize("name", TUNING_AND_ANALYSIS)
def test_tuning_and_analysis_are_covered(name):
    """The tuning loop, the new tools and the three analysers are among
    the files the import check reads, and none imports the JAX
    package's ``tools/`` (the analysers and the CLIs keep their own
    copies of what they need)."""
    assert name in {str(p.relative_to(ROOT)) for p in _port_files()}
    assert "tools" not in set(_imported_roots(ROOT / name))


def test_fleet_without_device_refuses_cpu_fallback():
    """``ServingFleet(devices=None)`` places replicas on the card: with
    no card it raises before building any engine."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from skycomputing_tpu_torch.fleet import ServingFleet
    from skycomputing_tpu_torch.models.gpt import (
        GptConfig,
        gpt_layer_configs,
        random_state_dicts,
    )

    cfg = GptConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                    num_attention_heads=2, max_position_embeddings=32,
                    dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFleet(layer_cfgs, random_state_dicts(layer_cfgs, 0),
                     replicas=2, engine_kwargs=dict(max_len=32,
                                                    buckets=(8,)))


def test_bench_serving_without_device_refuses_cpu_fallback():
    """``python -m skycomputing_tpu_torch.bench_serving`` with no
    ``--device`` serves on the card: without one it fails before any
    section runs and writes no report."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "skycomputing_tpu_torch.bench_serving",
         "--smoke", "--out", os.devnull], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert "running" not in proc.stdout


def test_pipeline_without_devices_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd

    cfg = bert_config("tiny", dtype="float32", use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=1,
                                   deterministic=True)
    wm = WorkerManager()
    wm.load_worker_pool_from_config([dict(name="node-0")])
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelineModel(wm, ps, sgd(1e-3), cross_entropy_loss)


@pytest.mark.parametrize("engine", ["bert", "gpt", "tp", "ep"])
def test_spmd_engines_without_devices_refuse_cpu_fallback(engine):
    """The compiled SPMD pipelines and the tensor- and expert-parallel
    meshes built with ``devices=None`` take the CUDA devices, and raise
    on a box with none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from skycomputing_tpu_torch.models import bert_config
    from skycomputing_tpu_torch.models.gpt import GptConfig
    from skycomputing_tpu_torch.parallel import (
        CompiledBertPipeline,
        CompiledGptPipeline,
        make_dp_pp_mesh,
        make_ep_mesh,
        make_pipeline_mesh,
        make_tp_mesh,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        if engine == "bert":
            CompiledBertPipeline(bert_config("tiny", dtype="float32"),
                                 make_dp_pp_mesh(1, 2), units_per_stage=1)
        elif engine == "gpt":
            CompiledGptPipeline(GptConfig(hidden_size=16,
                                          num_attention_heads=2),
                                make_pipeline_mesh(2), units_per_stage=1)
        elif engine == "tp":
            make_tp_mesh(2)
        else:
            make_ep_mesh(2)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """No card: a non-zero exit and no result line, in the checkout and
    in a directory holding nothing but the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
