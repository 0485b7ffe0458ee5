"""What the benchmark loads: no JAX, no JAX package; references that
import nothing of the program; no result without the card or the
program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.tests.conftest import ROOT, TINY_TRAIN, write_root

FORBIDDEN = ("jax", "jaxlib", "flax", "skycomputing_tpu")


def _python(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    root = write_root(tmp_path / "root")
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark import run
rc = run.main(['--workload', {TINY_TRAIN!r}, '--seed', '3', '--seconds', '1'],
              root=Path({str(root)!r}), device='cpu')
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps(dict(rc=rc, tops=tops)))
"""
    proc = _python(code, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert "skycomputing_tpu_torch" in out["tops"]
    assert not set(out["tops"]) & set(FORBIDDEN), out["tops"]


def test_references_import_nothing_of_the_program(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.bert, benchmark.reference.gpt
import benchmark.reference.precision
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    proc = _python(code, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"skycomputing_tpu_torch", *FORBIDDEN}, tops


def test_no_result_without_a_card(tmp_path):
    """Without a CUDA device the command fails and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this is the no-card path")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bert-large.s128-b256", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: the program is missing, so no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    write_root(tmp_path / "data")
    code = f"""
import sys
sys.path = [p for p in sys.path if not p.startswith({str(ROOT)!r})]
sys.path.insert(0, {str(tmp_path)!r})
from pathlib import Path
from benchmark import run
sys.exit(run.main(['--workload', {TINY_TRAIN!r}, '--seed', '1',
                   '--seconds', '1'], root=Path({str(tmp_path / 'data')!r}),
                  device='cpu'))
"""
    proc = _python(code, tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "missing" in proc.stderr
