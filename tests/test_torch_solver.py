"""The port's own copies of the host-side allocation math against the
JAX package on the same numpy inputs: the stimulator's draws, every
``dynamics/headline.py`` function, and ``solve_contiguous_minmax`` on
seeded instances through both the native core and the pure-Python
path — identical slices, device order, bottleneck and certified lower
bound — plus the native library's build into ``build/solver/``."""

import numpy as np
import pytest

from skycomputing_tpu.dynamics import headline as jheadline
from skycomputing_tpu.dynamics.solver import (
    solve_contiguous_minmax as jax_solve,
)
from skycomputing_tpu.stimulator import Stimulator as JaxStimulator
from skycomputing_tpu_torch.dynamics import headline, native
from skycomputing_tpu_torch.dynamics.solver import solve_contiguous_minmax
from skycomputing_tpu_torch.stimulator import Stimulator

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("workers", [1, 4, 8, 64])
def test_stimulator_draws_equal_jax(workers):
    kw = dict(compute_range=(1.0, 2.0), compute_seed=32)
    for kwargs in ({}, kw):
        got, ref = Stimulator(workers, **kwargs), JaxStimulator(workers,
                                                                **kwargs)
        for name in ("m_slowdown", "n_slowdown", "c_slowdown"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(ref, name))
        for i in range(workers + 1):
            assert got.compute_slowdown(i) == ref.compute_slowdown(i)
            assert got.memory_slowdown(i) == ref.memory_slowdown(i)
            assert got.network_stimulate(i) == ref.network_stimulate(i)


@pytest.mark.parametrize("workers", [2, 4, 8, 32])
def test_headline_functions_equal_jax(workers):
    for kind in ("paper", "stimulator"):
        np.testing.assert_array_equal(
            headline.worker_slowdowns(workers, kind),
            jheadline.worker_slowdowns(workers, kind))
    np.testing.assert_array_equal(headline.memory_skew(workers),
                                  jheadline.memory_skew(workers))
    layer_mem = list(np.random.default_rng(workers).uniform(1, 9, 40))
    for regime in ("reference", "tight"):
        assert headline.worker_mem_budget_mb(layer_mem, workers, regime) \
            == jheadline.worker_mem_budget_mb(layer_mem, workers, regime)
    taus = list(np.random.default_rng(workers + 1).uniform(0.1, 2, workers))
    for m in (1, 4, 16):
        for sequential in (False, True):
            assert headline.schedule_step_time(taus, m, sequential) == \
                jheadline.schedule_step_time(taus, m, sequential)
    assert headline.even_partition(75, workers) == \
        jheadline.even_partition(75, workers)
    for bad in (("worker_slowdowns", (workers, "vibes")),
                ("worker_mem_budget_mb", (layer_mem, workers, "vibes"))):
        with pytest.raises(ValueError):
            getattr(headline, bad[0])(*bad[1])


@pytest.mark.parametrize("regime", ["reference", "tight"])
def test_evaluate_instance_equals_jax(regime):
    rng = np.random.default_rng(3)
    flops = list(rng.uniform(1, 5, 30))
    mem = list(rng.uniform(100, 900, 30))
    slow = headline.worker_slowdowns(4, "paper")
    got = headline.evaluate_instance(flops, mem, slow, num_microbatches=4,
                                     regime=regime)
    ref = jheadline.evaluate_instance(flops, mem, slow, num_microbatches=4,
                                      regime=regime)
    for key in ("step_time_even", "step_time_optimal", "speedup_pct",
                "tau_even", "tau_optimal", "mem_budget_mb"):
        assert got[key] == ref[key], key
    for field in ("device_order", "slices", "bottleneck", "lower_bound"):
        assert getattr(got["solver_result"], field) == \
            getattr(ref["solver_result"], field)
    assert list(slow) == [3.0, 5.0, 3.0, 6.0]


def _instance(layers, devices, seed, speeds="mixed", tight=False):
    rng = np.random.default_rng(seed)
    cost = list(rng.uniform(0.5, 3.0, layers))
    mem = list(rng.uniform(0.1, 1.0, layers))
    if speeds == "classes":  # a few integer slowdowns, repeated
        dt = list(rng.integers(1, 4, devices).astype(float))
    else:
        dt = list(rng.uniform(1.0, 6.0, devices))
    cap = 1.6 * sum(mem) / devices if tight else 1000.0
    dmem = list(rng.uniform(0.8, 1.2, devices) * cap)
    return cost, mem, dt, dmem


# (layers, devices, seed, speeds, tight): the exact DP (native and
# Python), the Python greedy + anneal beyond 12 devices, the native
# count-vector DP over speed classes and the native anneal beyond 18
INSTANCES = [
    (9, 2, 0, "mixed", False),
    (16, 3, 1, "mixed", True),
    (24, 4, 2, "mixed", False),
    (30, 6, 3, "mixed", True),
    (40, 8, 4, "classes", False),
    (20, 14, 5, "mixed", False),
    (30, 20, 6, "classes", False),
    (24, 20, 7, "mixed", False),
]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("inst", INSTANCES,
                         ids=lambda i: f"L{i[0]}-D{i[1]}-{i[3]}"
                         f"{'-tight' if i[4] else ''}")
def test_solver_equals_jax(inst, use_native):
    layers, devices, seed, speeds, tight = inst
    args = _instance(layers, devices, seed, speeds, tight)
    # one anneal round on an eval budget alone (the wall cap never binds)
    kw = dict(use_native=use_native, anneal_seconds=600.0, anneal_evals=20,
              anneal_rounds=1)
    got = solve_contiguous_minmax(*args, **kw)
    ref = jax_solve(*args, **kw)
    assert got.device_order == ref.device_order
    assert [tuple(s) for s in got.slices] == [tuple(s) for s in ref.slices]
    assert got.bottleneck == ref.bottleneck
    assert got.lower_bound == ref.lower_bound
    # contiguous full coverage on distinct devices
    assert got.slices[0][0] == 0 and got.slices[-1][1] == layers
    assert all(a[1] == b[0] for a, b in zip(got.slices, got.slices[1:]))
    assert len(set(got.device_order)) == len(got.device_order)
    if use_native:
        assert got.path.startswith("native")
    else:
        assert got.path == ("python_exact" if devices <= 12
                            else "python_greedy")


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_solver_infeasible_raises_like_jax(use_native):
    args = ([1.0] * 6, [10.0] * 6, [1.0, 2.0], [15.0, 15.0])
    for solve in (solve_contiguous_minmax, jax_solve):
        with pytest.raises(RuntimeError, match="infeasible"):
            solve(*args, use_native=use_native)
    empty = solve_contiguous_minmax([], [], [1.0], [1.0])
    assert (empty.slices, empty.bottleneck) == ([], 0.0)
    with pytest.raises(ValueError, match="no devices"):
        solve_contiguous_minmax([1.0], [1.0], [], [])


def test_native_core_builds_into_the_ignored_build_dir():
    lib = native.load()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "solver")
    # nothing is written beside the tracked source
    assert sorted(p.name for p in native.SRC.parent.iterdir()
                  if p.suffix in (".so", ".tmp")) == []
