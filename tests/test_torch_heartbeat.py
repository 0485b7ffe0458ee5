"""The port's peer-liveness detection (``parallel/heartbeat.py``,
``HeartbeatHook``) against the contracts of ``tests/test_heartbeat.py``:
a beat that completes (healthy), a beat that stalls past the timeout
(the watchdog fires, and a blip that then completes clears only its own
latch), a beat whose collective raises (detection, not a crash), and a
REAL two-process gloo world where one peer exits and the survivor
detects it.  ``HeartbeatHook`` consumes the fault harness's
``drop_beat`` as the JAX hook does, on the same plans."""

import textwrap
import threading

import jax
import numpy as np
import optax
import pytest
import torch

import skycomputing_tpu.dynamics as jdyn
import skycomputing_tpu.runner as jrun
from skycomputing_tpu.ops import cross_entropy_loss as jax_xent
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu_torch import dynamics as tdyn
from skycomputing_tpu_torch import runner as trun
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import PeerHeartbeat, PipelineModel, sgd
from skycomputing_tpu_torch.registry import HOOKS

from test_torch_multihost import run_world

pytestmark = pytest.mark.torch_port


def test_beat_healthy_single_process():
    hb = PeerHeartbeat(timeout_s=60.0, device="cpu")
    assert hb.beat() is True
    assert hb.failed is False
    assert hb.beats == 1
    assert hb.last_beat_s is not None and hb.last_beat_s < 60.0


def _watched():
    """(reasons, an event the failure callback sets, the callback)."""
    reasons, fired = [], threading.Event()

    def on_failure(reason):
        reasons.append(reason)
        fired.set()

    return reasons, fired, on_failure


def test_beat_timeout_fires_watchdog():
    reasons, fired, on_failure = _watched()
    hb = PeerHeartbeat(timeout_s=0.05, on_failure=on_failure, device="cpu")
    hb._build()
    real_fn = hb._beat_fn

    def stalled(x):
        # the collective completes only after this beat's watchdog fired
        assert fired.wait(timeout=60.0)
        return real_fn(x)

    hb._beat_fn = stalled
    # the watchdog fires mid-beat (on_failure sees the blip), but the
    # collective then completes with the right sum — transient slowness
    # clears the latch instead of permanently poisoning beat()
    assert hb.beat() is True
    assert hb.failed is False
    assert reasons and "did not complete" in reasons[0]
    # a healthy follow-up beat stays healthy
    hb._beat_fn = real_fn
    assert hb.beat() is True
    assert hb.failed is False


def test_blip_recovery_does_not_erase_prior_real_failure():
    """A wrong-sum beat latches failed=True; a later slow-but-successful
    beat (watchdog fires, sum correct) must NOT clear that latch."""
    reasons, fired, on_failure = _watched()
    hb = PeerHeartbeat(timeout_s=0.05, on_failure=on_failure, device="cpu")
    hb._build()
    real_fn = hb._beat_fn

    hb._beat_fn = lambda x: hb._expected - 1.0  # a dropped peer
    assert hb.beat() is False
    assert hb.failed is True
    fired.clear()

    def slow_but_correct(x):
        assert fired.wait(timeout=60.0)  # this beat's watchdog fired
        return real_fn(x)

    hb._beat_fn = slow_but_correct
    assert hb.beat() is False  # prior real failure must persist
    assert hb.failed is True


def test_beat_exception_counts_as_detection():
    reasons = []
    hb = PeerHeartbeat(timeout_s=60.0, on_failure=reasons.append,
                       device="cpu")
    hb._build()

    def broken(x):
        raise RuntimeError("peer closed connection")

    hb._beat_fn = broken
    assert hb.beat() is False
    assert hb.failed is True
    assert reasons and "raised" in reasons[0]


def test_beat_without_a_card_or_cpu_request_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the beat would run on it")
    reasons = []
    hb = PeerHeartbeat(timeout_s=60.0, on_failure=reasons.append)
    assert hb.beat() is False
    assert reasons and "no CUDA device" in reasons[0]


_SURVIVOR = textwrap.dedent(
    """
    import os, time
    from skycomputing_tpu_torch.parallel import (
        PeerHeartbeat, initialize_from_env,
    )

    assert initialize_from_env(device="cpu") is True

    def report_and_exit(reason):
        # the main thread may be blocked inside the wedged collective,
        # so the detection path reports and exits — what HeartbeatHook's
        # 'abort' action does in production
        print(f"DETECTED_PEER_DEATH {time.perf_counter() - t0:.3f}",
              flush=True)
        os._exit(0)

    hb = PeerHeartbeat(timeout_s=30.0, on_failure=report_and_exit,
                       device="cpu")
    assert hb.beat(), "first beat failed with both peers alive"
    print("BEAT1_OK", flush=True)
    if os.environ["SKYTPU_PROCESS_ID"] == "1":
        os._exit(0)               # the peer dies without leaving the world
    # survivor: the next beat cannot complete; gloo's error (or the
    # watchdog, should the socket hang) triggers report_and_exit
    t0 = time.perf_counter()
    hb.beat()
    raise SystemExit("dead peer went undetected")
    """
)


def test_two_process_peer_death_is_detected():
    (rc0, out0, err0), (rc1, out1, _) = run_world(_SURVIVOR)
    assert "BEAT1_OK" in out0, f"rc={rc0}\n{out0}\n{err0}"
    assert "DETECTED_PEER_DEATH" in out0, f"rc={rc0}\n{out0}\n{err0}"
    assert rc0 == 0 and rc1 == 0 and "BEAT1_OK" in out1


# --- HeartbeatHook and the fault harness's drop_beat -------------------------

FEATURES, LAYERS = 16, 4


def _batches(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, FEATURES)).astype(np.float32),
             rng.integers(0, FEATURES, size=(8,)).astype(np.int32))
            for _ in range(n)]


def _runner(pkg, plan_events, interval, iters=6):
    """A 4-unit ``MatmulStack`` pipeline over 2 workers of one package
    with its ``FaultInjectionHook`` and ``HeartbeatHook``."""
    dyn, run = (jdyn, jrun) if pkg == "jax" else (tdyn, trun)
    mc = [dict(layer_type="MatmulStack", features=FEATURES, depth=1,
               dtype="float32") for _ in range(LAYERS)]
    wm = dyn.WorkerManager()
    wm.load_worker_pool_from_config(
        [dict(name=f"n{i}", device_config=dict(device_index=0),
              extra_config={}) for i in range(2)])
    dyn.Allocator(mc, wm, None, None).even_allocate()
    if pkg == "jax":
        ps = dyn.ParameterServer(mc, example_inputs=(_batches(1)[0][0],),
                                 rng=jax.random.key(0))
        model = JaxPipelineModel(wm, ps, optax.sgd(1e-2), jax_xent)
        hb = run.HeartbeatHook(interval=interval, timeout_s=60.0,
                               action="stop")
    else:
        ps = dyn.ParameterServer(mc)
        model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                              devices=[torch.device("cpu")])
        hb = run.HeartbeatHook(interval=interval, timeout_s=60.0,
                               action="stop", device="cpu")
    runner = run.Runner(model, ps, wm, max_epochs=100, max_iters=iters)
    faults = dyn.FaultInjectionHook(dyn.FaultPlan(plan_events))
    runner.register_hook(faults)
    runner.register_hook(hb)
    runner.train(_batches())
    drops = [dict(iter=e["fired_at"], consumed=e.get("consumed", True))
             for e in faults.applied if e["kind"] == "drop_beat"]
    return runner, hb, drops


@pytest.mark.parametrize("interval,plan,beats,consumed", [
    # 6 iterations, a beat every iteration, 2 dropped, both consumed
    (1, [dict(iter=2, kind="drop_beat"), dict(iter=4, kind="drop_beat")],
     4, [True, True]),
    # a drop armed where no beat is scheduled is recorded unconsumed;
    # iteration 5's beat happens normally
    (5, [dict(iter=2, kind="drop_beat")], 1, [False]),
], ids=["every_iter", "interval_mismatch"])
def test_heartbeat_hook_consumes_drop_beat_as_the_reference_does(
        interval, plan, beats, consumed):
    results = {pkg: _runner(pkg, plan, interval) for pkg in ("jax", "torch")}
    runner, hb, drops = results["torch"]
    assert runner.iter == 6 and runner.aborted is False
    assert hb.heartbeat.beats == beats and hb.heartbeat.failed is False
    assert [d["consumed"] for d in drops] == consumed
    jrunner, jhb, jdrops = results["jax"]
    assert (jrunner.iter, jhb.heartbeat.beats, jdrops) == (
        runner.iter, hb.heartbeat.beats, drops)


def test_heartbeat_hook_is_registered_and_checks_its_action():
    assert HOOKS.get_module("HeartbeatHook") is trun.HeartbeatHook
    with pytest.raises(ValueError, match="unknown action"):
        trun.HeartbeatHook(action="restart")
