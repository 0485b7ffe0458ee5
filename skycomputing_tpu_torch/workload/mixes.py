"""Named numpy request mixes (the port's own copy of
``skycomputing_tpu/workload/mixes.py``).

The benches' workloads under stable names, with the reference's exact
``numpy.random.Generator`` draw orders: given the same
``numpy.random.default_rng(seed)`` state and config, every mix returns
the specs the JAX package's returns, byte for byte
(``tests/test_torch_bench_serving.py`` holds them equal).  The port's
serving bench consumes the ``interference`` mix by name; the fleet
bench's mixes come with the fleet plane.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

#: name -> builder; the benches' ``--scenario``-style lookup surface
MIXES: Dict[str, Callable[..., Any]] = {}


def _register(name: str):
    def deco(fn):
        MIXES[name] = fn
        return fn

    return deco


def build_mix(name: str, rng: np.random.Generator, **cfg) -> Any:
    """Resolve a named mix; unknown names fail with the registry in
    the message."""
    builder = MIXES.get(name)
    if builder is None:
        raise ValueError(
            f"unknown workload mix {name!r}; known: {sorted(MIXES)}"
        )
    return builder(rng, **cfg)


@_register("interference")
def interference_specs(
    rng: np.random.Generator, icfg: Dict[str, Any]
) -> List[Tuple[np.ndarray, int]]:
    """The prefill-vs-decode interference mix (the serving bench's
    chunked-backlog workload): long-prompt/short-decode CHURNERS whose
    admission waves are expensive, interleaved with short-prompt/
    short-decode requests whose inter-token latency measures the
    damage.  Shuffled so admissions interleave.  Draw order: per
    churner (plen, n, prompt tokens), then per small request the same,
    then one permutation."""
    specs = []
    for _ in range(icfg["n_churn"]):
        plen = int(rng.integers(*icfg["churn_prompt"]))
        n = int(rng.integers(*icfg["churn_new"]))
        specs.append((rng.integers(1, 400, (plen,)).astype(np.int32), n))
    for _ in range(icfg["n_small"]):
        plen = int(rng.integers(*icfg["small_prompt"]))
        n = int(rng.integers(*icfg["small_new"]))
        specs.append((rng.integers(1, 400, (plen,)).astype(np.int32), n))
    order = rng.permutation(len(specs))
    return [specs[i] for i in order]


__all__ = ["MIXES", "build_mix", "interference_specs"]
