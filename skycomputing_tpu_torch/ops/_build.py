"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes)
exports a plain C interface and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``<checkout>/build/kernels/``, then loaded with
:mod:`ctypes`.  No PyTorch header is included, so a build takes
seconds.  The library's file name carries a hash of the source, the
headers and the flags, so an edited source or header is rebuilt and
never loaded stale; the compiler writes a temporary file that is
renamed into place, so concurrent first uses in several processes
cannot load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --split-compile=0: the optimizer's passes over a source's many kernel
# instantiations run on every core (chip_smoke.py builds the sources at
# once inside its time limit)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's usual install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hashed over the source, the
    headers beside it and the flags)."""
    content = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        header.read_bytes() for header in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        content + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path.  Raises with the compiler's output when
    ``nvcc`` fails."""
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    # ptxas -v reports registers, shared memory and spills per kernel
    (BUILD_DIR / f"{target.stem}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return target


_PTXAS_FIELDS = (
    ("stack_bytes", re.compile(r"(\d+) bytes stack frame")),
    ("spill_store_bytes", re.compile(r"(\d+) bytes spill stores")),
    ("spill_load_bytes", re.compile(r"(\d+) bytes spill loads")),
    ("registers", re.compile(r"Used (\d+) registers")),
    ("static_smem_bytes", re.compile(r"(\d+) bytes smem")),
)


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """``ptxas -v`` output by mangled kernel name: registers, spill
    stores and loads, stack frame and static shared memory, in bytes
    but for the registers (a kernel's dynamic shared memory is its own
    to report)."""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = report.setdefault(entry.group(1), {})
            continue
        if current is None:
            continue
        for field, pattern in _PTXAS_FIELDS:
            found = pattern.search(line)
            if found:
                current[field] = int(found.group(1))
    return report


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_ptxas` of the build log of ``csrc/<name>.cu``; empty
    if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return parse_ptxas(log.read_text()) if log.exists() else {}


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if
    needed; loaded once per process.  ``load.count`` counts the loads (a
    kernel's first use in a process, with its build where the library
    was not on disk): the port's twin of a compile, which a measured
    window must not contain."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        load.count += 1
    return lib


load.count = 0


__all__ = ["BUILD_DIR", "CSRC", "build", "library_path", "load", "nvcc_path",
           "parse_ptxas", "ptxas_report"]
