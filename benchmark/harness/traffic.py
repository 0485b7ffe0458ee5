"""Seeded traffic: length draws, the size pool and its order.

One general generator reads every traffic file.  A length spec is
``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
(clipped) or ``{"dist": "uniform", "min": a, "max": b}`` (inclusive).

Serving sizes come from a pool drawn once from the traffic file's own
``size_seed``, so every run seed serves the same multiset of (prompt,
output) sizes; the run seed only orders the pool and draws the tokens.
That keeps the work of a run independent of its seed.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np


def draw(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` integer lengths from ``spec``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        raw = np.exp(np.log(spec["median"]) + spec["sigma"]
                     * rng.standard_normal(n))
        return np.clip(np.rint(raw), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def size_pool(sizes: Dict) -> np.ndarray:
    """``[pool, 2]`` (prompt, output) sizes from ``sizes["size_seed"]``;
    outputs are cut so that prompt + output <= ``sizes["max_total"]``."""
    rng = np.random.default_rng(int(sizes["size_seed"]))
    n = int(sizes["pool"])
    prompt = draw(sizes["prompt"], n, rng)
    output = draw(sizes["output"], n, rng)
    output = np.minimum(output, int(sizes["max_total"]) - prompt)
    if (output < 1).any():
        raise ValueError("a prompt leaves no room for its output")
    return np.stack([prompt, output], axis=1)


def order(n: int, seed: int) -> np.ndarray:
    """The run seed's permutation of ``n`` pool entries."""
    return np.random.default_rng(int(seed)).permutation(n)


def digest(*arrays: np.ndarray) -> str:
    """A hex digest of the arrays' values and shapes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()
