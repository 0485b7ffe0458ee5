"""Named numpy request mixes (the port's own copy of
``skycomputing_tpu/workload/mixes.py``).

The benches' workloads under stable names, with the reference's exact
``numpy.random.Generator`` draw orders: given the same
``numpy.random.default_rng(seed)`` state and config, every mix returns
the specs the JAX package's returns, byte for byte
(``tests/test_torch_bench_serving.py`` holds them equal).  The port's
serving bench consumes the ``interference`` mix by name; the fleet
bench's (``tools/bench_fleet``) by name too: ``fleet_bursty`` and
``fleet_spike``.
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


def fleet_request_spec(
    rng: np.random.Generator, *, prompt_lo: int = 8,
    prompt_hi: int = 60, vocab: int = 500, new_lo: int = 16,
    new_hi: int = 28,
) -> Tuple[np.ndarray, int]:
    """One ``bench_fleet`` request spec: draw order plen, prompt
    tokens, max_new — the reference's draws, byte for byte."""
    plen = int(rng.integers(prompt_lo, prompt_hi))
    prompt = rng.integers(1, vocab, (plen,)).astype(np.int32)
    return prompt, int(rng.integers(new_lo, new_hi))


@_register("fleet_bursty")
def fleet_bursty_arrivals(
    rng: np.random.Generator, *, n: int, burst: int, gap: int,
    start: int = 0, **spec_kw,
) -> List[Tuple[int, Tuple[np.ndarray, int]]]:
    """``bench_fleet``'s steady phase: bursts of ``burst`` requests
    every ``gap`` ticks (the ~90%-utilization knife's-edge shape its
    docstring argues for), each request drawn by
    :func:`fleet_request_spec` in arrival order."""
    return [
        (start + gap * (i // burst), fleet_request_spec(rng, **spec_kw))
        for i in range(int(n))
    ]


@_register("fleet_spike")
def fleet_spike_specs(
    rng: np.random.Generator, *, n: int, **spec_kw,
) -> List[Tuple[np.ndarray, int]]:
    """``bench_fleet``'s admission-spike phase: ``n`` back-to-back
    request specs (the bench paces them 2/tick itself)."""
    return [fleet_request_spec(rng, **spec_kw) for _ in range(int(n))]


__all__ = [
    "MIXES",
    "build_mix",
    "fleet_bursty_arrivals",
    "fleet_request_spec",
    "fleet_spike_specs",
    "interference_specs",
]
