"""The port stands alone: no module of ``skycomputing_tpu_torch`` and
nothing in ``chip_smoke.py`` imports ``jax``, ``flax`` or the JAX
package; the package imports with those blocked; an engine or a
pipeline asked for no device refuses to fall back to the CPU; and
``chip_smoke.py`` fails without a CUDA device, also when it stands alone
in a directory."""

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
    return files + [ROOT / "chip_smoke.py"]


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
                      max_len=32, buckets=(8,))


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
