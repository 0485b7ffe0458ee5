"""Native solver core: build at first use + ctypes binding (the port's
own copy of ``skycomputing_tpu/dynamics/native``).

``solver.cpp`` exposes a C ABI and is compiled with ``g++`` at first use
into ``<checkout>/build/solver/`` — never beside the tracked source.  The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and never loaded stale; the compiler writes a
temporary file that is renamed into place, so processes that build at
the same time never load a half-written library.  Any failure (no
compiler, a read-only checkout) is logged once and leaves the solver on
its pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from ...utils import Logger

SRC = Path(__file__).resolve().parent / "solver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "solver"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where ``solver.cpp`` builds to (content- and flag-hashed)."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libskytpu_solver-{digest}.so"


def _build() -> Path:
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


_DOUBLES = ctypes.POINTER(ctypes.c_double)
_INTS = ctypes.POINTER(ctypes.c_int)


def load() -> Optional[ctypes.CDLL]:
    """The solver library, or None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as exc:
            Logger().warning(
                f"native solver unavailable ({exc!r}); the allocator "
                f"solves on its Python path"
            )
            return None
        lib.skytpu_solve_minmax.restype = ctypes.c_int
        lib.skytpu_solve_minmax.argtypes = [
            ctypes.c_int, ctypes.c_int, _DOUBLES, _DOUBLES, _DOUBLES,
            _DOUBLES, ctypes.c_double, ctypes.c_int, _INTS, _INTS, _INTS,
            _DOUBLES,
        ]
        lib.skytpu_solve_large.restype = ctypes.c_int
        lib.skytpu_solve_large.argtypes = [
            ctypes.c_int, ctypes.c_int, _DOUBLES, _DOUBLES, _DOUBLES,
            _DOUBLES, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, _INTS, _INTS, _INTS, _DOUBLES,
        ]
        lib.skytpu_solve_classes.restype = ctypes.c_int
        lib.skytpu_solve_classes.argtypes = [
            ctypes.c_int, ctypes.c_int, _DOUBLES, _DOUBLES, _INTS, _DOUBLES,
            _DOUBLES, ctypes.c_double, ctypes.c_int, ctypes.c_longlong,
            _INTS, _INTS, _INTS, _DOUBLES,
        ]
        _lib = lib
        return _lib


def _doubles(xs):
    return (ctypes.c_double * len(xs))(*[float(x) for x in xs])


def _ints(xs):
    return (ctypes.c_int * len(xs))(*[int(x) for x in xs])


def _result(used, L, D, out_order, out_starts, out_ends, out_bottleneck,
            infeasible: str):
    """The (order, slices, bottleneck) triple of a native call; None for
    an out-of-range size (-2), RuntimeError for an infeasible instance."""
    if used == -2:
        return None
    if used < 0:
        raise RuntimeError(infeasible)
    order = [out_order[i] for i in range(used)]
    slices = [(out_starts[i], out_ends[i]) for i in range(used)]
    return order, slices, float(out_bottleneck.value)


def _infeasible(L: int, D: int) -> str:
    return ("allocation infeasible: memory capacities cannot hold the model "
            f"(layers={L}, devices={D})")


def solve_minmax_native(
    layer_cost, layer_mem, device_time, device_mem,
    tolerance: float = 1e-3, max_iters: int = 60,
) -> Optional[Tuple[List[int], List[Tuple[int, int]], float]]:
    """Native exact solve; None if the library is unavailable, a
    RuntimeError when the instance is infeasible."""
    lib = load()
    if lib is None:
        return None
    L, D = len(layer_cost), len(device_time)
    outs = [(ctypes.c_int * D)() for _ in range(3)]
    bottleneck = ctypes.c_double()
    used = lib.skytpu_solve_minmax(
        L, D, _doubles(layer_cost), _doubles(layer_mem),
        _doubles(device_time), _doubles(device_mem), tolerance, max_iters,
        *outs, ctypes.byref(bottleneck),
    )
    return _result(used, L, D, *outs, bottleneck, _infeasible(L, D))


def solve_large_native(
    layer_cost, layer_mem, device_time, device_mem, seed: int = 0,
    rounds: int = 6, evals0: int = 20000, wall_cap_s: float = 45.0,
    lower_bound: float = 0.0, gap_target: float = 0.01,
    tolerance: float = 1e-3,
) -> Optional[Tuple[List[int], List[Tuple[int, int]], float]]:
    """Native order anneal for device counts beyond the exact DP: scores
    an order by bisecting its greedy walk's bottleneck, anneals over
    orders in eval-count rounds of doubling budgets and polishes slice
    boundaries.  None if the library is unavailable; RuntimeError when
    no explored order covers the model."""
    lib = load()
    if lib is None:
        return None
    L, D = len(layer_cost), len(device_time)
    outs = [(ctypes.c_int * D)() for _ in range(3)]
    bottleneck = ctypes.c_double()
    used = lib.skytpu_solve_large(
        L, D, _doubles(layer_cost), _doubles(layer_mem),
        _doubles(device_time), _doubles(device_mem),
        int(seed) & 0xFFFFFFFFFFFFFFFF, int(rounds), int(evals0),
        float(wall_cap_s), float(lower_bound), float(gap_target),
        float(tolerance), *outs, ctypes.byref(bottleneck),
    )
    return _result(used, L, D, *outs, bottleneck, _infeasible(L, D))


def solve_classes_native(
    layer_cost, layer_mem, counts, class_dt, class_mem,
    tolerance: float = 1e-9, max_iters: int = 60,
    max_states: int = 8_000_000,
) -> Optional[Tuple[List[int], List[Tuple[int, int]], float]]:
    """Exact count-vector DP over device classes (few distinct speeds):
    (slice classes in pipeline order, slices, bottleneck); None when the
    library is unavailable or the size guard trips; RuntimeError when the
    class instance is infeasible."""
    lib = load()
    if lib is None:
        return None
    L, K = len(layer_cost), len(class_dt)
    D = sum(int(c) for c in counts)
    outs = [(ctypes.c_int * D)() for _ in range(3)]
    bottleneck = ctypes.c_double()
    used = lib.skytpu_solve_classes(
        L, K, _doubles(layer_cost), _doubles(layer_mem), _ints(counts),
        _doubles(class_dt), _doubles(class_mem), float(tolerance),
        int(max_iters), int(max_states), *outs, ctypes.byref(bottleneck),
    )
    return _result(used, L, D, *outs, bottleneck, "class instance infeasible")


__all__ = [
    "BUILD_DIR",
    "library_path",
    "load",
    "solve_classes_native",
    "solve_large_native",
    "solve_minmax_native",
]
