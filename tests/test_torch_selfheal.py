"""The port's fault injection and self-heal against the JAX package's
(``dynamics/faults.py``, ``SelfHealHook``), on injected clocks as
``tests/test_selfheal.py`` runs them: ``FaultPlan`` validates with the
reference's messages and draws its numbers; on the 10-unit
``MatmulStack`` world (3 workers, even) a straggler at iteration 5 is
detected, confirmed and healed at the same iteration, with the same
divergence and the same partitions, in both packages, and a transient
stall heals in neither; in exit mode both packages stage the same
payload and exit with ``REALLOC_RC`` at the same iteration; a ``nan``
fault trips ``NanGuardHook`` and the checkpoint skip; a truncated
checkpoint is refused on load; every checkpoint write syncs its
temporary file before the rename (fault C9); and ``retry_call`` backs
off on the reference's schedule."""

import json
import os
import os.path as osp

import jax
import numpy as np
import optax
import pytest
import torch

import skycomputing_tpu.dynamics as jdyn
import skycomputing_tpu.runner as jrun
import skycomputing_tpu.utils as jutils
from skycomputing_tpu.ops import cross_entropy_loss as jax_xent
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu.parallel.pipeline import StageRuntime as JaxStage
from skycomputing_tpu_torch import dynamics as tdyn
from skycomputing_tpu_torch import runner as trun
from skycomputing_tpu_torch import utils as tutils
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import PipelineModel, sgd
from skycomputing_tpu_torch.parallel.pipeline import StageRuntime

pytestmark = pytest.mark.torch_port

LAYERS, FEATURES, BATCH = 10, 64, 16
RAW_S_PER_LAYER = 0.01


# --- FaultPlan ----------------------------------------------------------------

BAD_PLANS = {
    "unknown_kind": [dict(iter=0, kind="meteor")],
    "no_iter": [dict(kind="stall", seconds=1.0)],
    "stall_no_seconds": [dict(iter=50, kind="stall")],
    "slowdown_no_factor": [dict(iter=1, kind="slowdown", worker=0)],
    "corrupt_no_path": [dict(iter=1, kind="corrupt_checkpoint")],
    "spike_no_replica": [dict(iter=1, kind="latency_spike")],
}


def _error(fn, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return str(info.value)


@pytest.mark.parametrize("case", sorted(BAD_PLANS))
def test_fault_plan_validation_matches_the_reference(case):
    assert _error(tdyn.FaultPlan, BAD_PLANS[case]) == \
        _error(jdyn.FaultPlan, BAD_PLANS[case])


def test_fault_plan_draws_and_hook_vocabulary_match_the_reference():
    events = [dict(iter=3, kind="stall", seconds=0.1),
              dict(iter=1, kind="drop_beat")]
    plans = [pkg.FaultPlan(events, seed=5) for pkg in (jdyn, tdyn)]
    draws = [[p.draw_fraction() for _ in range(3)]
             + [p.draw_spike_seconds(), p.draw_fraction(0.2, 0.4)]
             for p in plans]
    assert draws[1] == draws[0]
    assert plans[1].events == plans[0].events
    assert plans[1].events_at(3) == plans[0].events_at(3)
    stim = [pkg.FaultPlan.from_stimulator(4, at_iter=2) for pkg in (jdyn,
                                                                  tdyn)]
    assert stim[1].events == stim[0].events
    fleet = [dict(iter=0, kind="replica_crash", replica=0)]
    assert _error(tdyn.FaultInjectionHook, tdyn.FaultPlan(fleet)) == \
        _error(jdyn.FaultInjectionHook, jdyn.FaultPlan(fleet))


# --- the MatmulStack world -----------------------------------------------------

class _StaticDeviceBench:
    """Homogeneous device profile; heterogeneity comes from the faults."""

    def __init__(self, wm):
        self._wm = wm

    def benchmark(self):
        return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                for w in self._wm.worker_pool}


class _StaticModelBench:
    def __init__(self, n):
        self._n = n

    def benchmark(self):
        return [1.0] * self._n, [0.1] * self._n


def _batches(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, FEATURES)).astype(np.float32),
             rng.integers(0, FEATURES, size=(BATCH,)).astype(np.int32))
            for _ in range(n)]


def _model_cfg():
    return [dict(layer_type="MatmulStack", features=FEATURES, depth=3,
                 dtype="float32") for _ in range(LAYERS)]


def _measured(model):
    """The deterministic stand-in for ``measure_stage_times`` both
    packages get: raw seconds per layer x the stage's slowdown."""
    def measure(data, **_kw):
        return [stage.num_layers * RAW_S_PER_LAYER * max(stage.slowdown, 1.0)
                for stage in model.stages]
    return measure


def _world(pkg, seed=0):
    """(model, ps, wm, allocator) of one package, evenly allocated."""
    dyn = jdyn if pkg == "jax" else tdyn
    mc = _model_cfg()
    wm = dyn.WorkerManager()
    wm.load_worker_pool_from_config(
        [dict(name=f"n{i}", device_config=dict(device_index=0),
              extra_config={}) for i in range(3)])
    alloc = dyn.Allocator(mc, wm, _StaticModelBench(len(mc)),
                          _StaticDeviceBench(wm))
    alloc.even_allocate()
    if pkg == "jax":
        x = _batches(1, seed)[0][0]
        ps = dyn.ParameterServer(mc, example_inputs=(x,),
                                 rng=jax.random.key(seed))
        model = JaxPipelineModel(wm, ps, optax.sgd(1e-2), jax_xent)
    else:
        ps = dyn.ParameterServer(mc)
        model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                              devices=[torch.device("cpu")])
    model.measure_stage_times = _measured(model)
    return model, ps, wm, alloc


class _EmulatedIterClock:
    """Every read advances by a tick times the pipeline's worst emulated
    slowdown, so detection follows the injected fault, not the host."""

    def __init__(self, model, tick_s: float = 0.05):
        self._model = model
        self._tick_s = tick_s
        self._now = 0.0

    def __call__(self) -> float:
        worst = max(s.slowdown for s in self._model.stages)
        self._now += self._tick_s * worst
        return self._now


class _TransientStallClock:
    """Every iteration reads ``tick_s`` except ``stall_iter``, which reads
    ``tick_s + stall_s`` (two reads per iteration)."""

    def __init__(self, stall_iter, stall_s, tick_s=0.05):
        self._now, self._reads = 0.0, 0
        self._stall_iter, self._stall_s, self._tick_s = (
            stall_iter, stall_s, tick_s)

    def __call__(self) -> float:
        it, end_read = divmod(self._reads, 2)
        if end_read:
            self._now += self._tick_s + (
                self._stall_s if it == self._stall_iter else 0.0)
        self._reads += 1
        return self._now


@pytest.fixture
def no_emulation_sleep(monkeypatch):
    """The stages' slowdown emulation sleeps real time; the injected
    clocks already carry the slowdown."""
    for cls in (JaxStage, StageRuntime):
        monkeypatch.setattr(cls, "_sleep", staticmethod(lambda s: None))


def _run(pkg, plan_events, heal_kwargs, clock_for, iters):
    dyn, run = (jdyn, jrun) if pkg == "jax" else (tdyn, trun)
    model, ps, wm, alloc = _world(pkg)
    heal = run.SelfHealHook(alloc, clock=clock_for(model), **heal_kwargs)
    runner = run.Runner(model, ps, wm, max_epochs=100, max_iters=iters)
    runner.register_hook(dyn.FaultInjectionHook(dyn.FaultPlan(plan_events)))
    runner.register_hook(heal)
    runner.train(_batches())
    return heal, runner, wm, alloc


def _events(heal):
    out = []
    for ev in heal.events:
        row = dict(kind=ev["kind"], iter=ev["iter"])
        for key in ("old_partition", "new_partition"):
            if key in ev:
                row[key] = list(ev[key])
        if "divergence" in ev:
            row["divergence"] = {int(k): v
                                 for k, v in ev["divergence"].items()}
        out.append(row)
    return out


def test_straggler_heals_as_the_reference_does(no_emulation_sleep):
    fault = dict(iter=5, kind="slowdown", worker=0, factor=3.0)
    kwargs = dict(window=2, k_windows=2, threshold=1.35, grace_iters=1,
                  max_heals=1, measure_repeats=1, measure_inner=1,
                  solver_time_s=5.0)
    results = {pkg: _run(pkg, [fault], kwargs, _EmulatedIterClock, 20)
               for pkg in ("jax", "torch")}
    want, got = (_events(results[p][0]) for p in ("jax", "torch"))
    assert [(e["kind"], e["iter"]) for e in got] == \
        [(e["kind"], e["iter"]) for e in want]
    heals = [(g, w) for g, w in zip(got, want) if g["kind"] == "heal"]
    assert len(heals) == 1
    (g, w), = heals
    assert g["old_partition"] == w["old_partition"] == [4, 3, 3]
    assert g["new_partition"] == w["new_partition"]
    assert g["divergence"].keys() == w["divergence"].keys()
    for k in g["divergence"]:
        assert g["divergence"][k] == pytest.approx(w["divergence"][k],
                                                   abs=1e-9)
    assert max(g["divergence"], key=g["divergence"].get) == 0
    assert g["divergence"][0] > 1.5

    heal, runner, wm, alloc = results["torch"]
    assert heal.heals == 1 and runner.iter == 20
    slow = next(w for w in wm.worker_pool if w.stim_index == 0)
    assert len(slow.model_config) < 4
    cover = [u for w in sorted(wm.worker_pool, key=lambda w: w.rank)
             for u in (w.model_config or [])]
    assert cover == alloc._model_cfg
    # pre-flight before the first step and again after the rebuild
    assert [r.ok for r in runner.preflight_reports] == [True, True]
    assert runner.preflight_reports[1].stages == len(g["new_partition"])


def test_transient_stall_heals_in_neither_package(no_emulation_sleep):
    plan = [dict(iter=9, kind="stall", seconds=0.01)]
    kwargs = dict(window=3, k_windows=2, threshold=1.5, grace_iters=2,
                  max_heals=1)
    results = {
        pkg: _run(pkg, plan, kwargs,
                  lambda m: _TransientStallClock(stall_iter=9, stall_s=0.4),
                  18)
        for pkg in ("jax", "torch")}
    for heal, runner, _wm, _alloc in results.values():
        assert heal.heals == 0 and runner.iter == 18
    assert _events(results["torch"][0]) == _events(results["jax"][0])


def test_selfheal_exit_mode_waits_for_elastic():
    """Exit mode hands the heal to the elastic supervisor: it needs a
    snapshot path (the process and its parameter server go away), and
    with one it builds as the reference's does."""
    _model, _ps, _wm, alloc = _world("torch")
    with pytest.raises(ValueError, match="snapshot_path"):
        trun.SelfHealHook(alloc, mode="exit")
    with pytest.raises(ValueError, match="unknown mode"):
        trun.SelfHealHook(alloc, mode="restart", snapshot_path="snap.pt")
    hook = trun.SelfHealHook(alloc, mode="exit", snapshot_path="snap.pt")
    assert hook.heals == 0 and hook.events == []


def _exit_run(pkg, tmp_path):
    """A straggler at iteration 5 under ``SelfHealHook(mode="exit")`` on
    the emulated clock: (exit code, runner, hook, staged payload, ps)."""
    dyn, run = (jdyn, jrun) if pkg == "jax" else (tdyn, trun)
    model, ps, wm, alloc = _world(pkg)
    rdv = tmp_path / f"rdv_{pkg}"
    rdv.mkdir()
    snapshot = str(tmp_path / ("snap.msgpack" if pkg == "jax" else "snap.pt"))
    heal = run.SelfHealHook(
        alloc, window=2, k_windows=2, threshold=1.35, grace_iters=1,
        measure_repeats=1, measure_inner=1, mode="exit",
        snapshot_path=snapshot, rendezvous_dir=str(rdv),
        clock=_EmulatedIterClock(model))
    runner = run.Runner(model, ps, wm, max_epochs=100, max_iters=40)
    runner.register_hook(dyn.FaultInjectionHook(dyn.FaultPlan(
        [dict(iter=5, kind="slowdown", worker=0, factor=3.0)])))
    runner.register_hook(heal)
    with pytest.raises(SystemExit) as info:
        runner.train(_batches())
    assert osp.exists(snapshot)
    payload = json.loads((rdv / "realloc.json").read_text())
    return info.value.code, runner, heal, payload, (ps, snapshot)


def test_selfheal_exit_mode_stages_payload_as_the_reference_does(
        no_emulation_sleep, tmp_path):
    """Supervised path: instead of repartitioning in process, the hook
    snapshots, stages the cumulative device scales for the rendezvous
    and exits with REALLOC_RC, at the reference's iteration and with the
    reference's payload; a fresh allocator that applies the payload
    sheds layers from the slow worker."""
    from skycomputing_tpu.parallel.elastic import REALLOC_RC as JAX_RC
    from skycomputing_tpu_torch.parallel import REALLOC_RC

    got = _exit_run("torch", tmp_path)
    want = _exit_run("jax", tmp_path)
    (code, runner, heal, payload, (ps, snapshot)) = got
    assert code == REALLOC_RC == JAX_RC == want[0]
    assert runner.aborted is False  # a planned exit, not a crash
    assert sorted(payload) == sorted(want[3]) == [
        "device_scale", "epoch", "iter", "measured_stage_times"]
    assert (payload["iter"], payload["epoch"]) == (
        want[3]["iter"], want[3]["epoch"])
    assert payload["device_scale"].keys() == want[3]["device_scale"].keys()
    for k, v in payload["device_scale"].items():
        assert v == pytest.approx(want[3]["device_scale"][k], abs=1e-6)
    assert payload["device_scale"]["0"] > 1.5  # the straggler dominates
    assert len(payload["measured_stage_times"]) == 3
    assert [(e["kind"], e["iter"]) for e in heal.events] == [
        (e["kind"], e["iter"]) for e in want[2].events]
    assert heal.events[-1]["kind"] == "heal_exit"

    # the snapshot restores the live weights exactly
    ps2 = tdyn.ParameterServer(list(ps._model_config))
    ps2.load_weights_from_file(snapshot)
    for a, b in zip(ps2.params, ps.params):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)

    # a fresh allocator (the relaunched trainer's) applies the carried
    # scales and routes work away from the degraded node: with uniform
    # layers it must shed layers from the even split's 4
    _model2, _ps2, wm2, alloc2 = _world("torch")
    alloc2.apply_device_scales(payload["device_scale"])
    alloc2.optimal_allocate(max_time=5.0)
    slow = next(w for w in wm2.worker_pool if w.stim_index == 0)
    assert len(slow.model_config or []) < 4


# --- fault C9: checkpoint writes sync before they rename ---------------------

@pytest.fixture
def sync_log(monkeypatch):
    """Wraps ``os.fsync`` and ``os.replace``: each event with the inode
    of the file synced or renamed from."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        events.append(("fsync", os.fstat(fd).st_ino))
        return real_fsync(fd)

    def replace(src, dst, *args, **kwargs):
        events.append(("replace", os.stat(src).st_ino, osp.basename(dst)))
        return real_replace(src, dst, *args, **kwargs)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    return events


def _renames_synced(events):
    """The renamed files' names, each checked synced just before."""
    names = []
    for i, event in enumerate(events):
        if event[0] == "replace":
            assert i > 0 and events[i - 1] == ("fsync", event[1]), events
            names.append(event[2])
    return names


def test_parameter_server_save_syncs_before_rename(sync_log, tmp_path):
    _model, ps, _wm, _alloc = _world("torch")
    path = str(tmp_path / "ckpt.pt")
    ps.save_weights_to_file(path)
    assert _renames_synced(sync_log) == ["ckpt.pt"]
    ps2 = tdyn.ParameterServer(list(ps._model_config))
    ps2.load_weights_from_file(path)
    assert all(torch.equal(a[k], b[k])
               for a, b in zip(ps2.params, ps.params) for k in a)


def test_checkpoint_hook_saves_sync_before_rename(sync_log, tmp_path):
    model, ps, wm, _alloc = _world("torch")
    runner = trun.Runner(model, ps, wm, max_epochs=1, max_iters=100)
    runner.register_hook(trun.CheckpointHook(
        save_path=str(tmp_path / "ck"), save_interval=1,
        save_training_state=True))
    runner.train(_batches(2))
    assert _renames_synced(sync_log) == [
        "epoch_1.pt", "epoch_1.pt.train_state.pt"]


@pytest.mark.parametrize("data", [b"bytes", "text"], ids=["bytes", "str"])
def test_atomic_write_syncs_as_the_reference_does(sync_log, tmp_path, data):
    for pkg, write in (("jax", jutils.atomic_write),
                       ("torch", tutils.atomic_write)):
        write(str(tmp_path / pkg), data, tmp_suffix=f".tmp{pkg}")
    assert _renames_synced(sync_log) == ["jax", "torch"]
    assert (tmp_path / "jax").read_bytes() == (tmp_path / "torch").read_bytes()


# --- nan, torn checkpoints, dropped beats ------------------------------------

def test_nan_fault_trips_nan_guard_and_checkpoint_skip(tmp_path):
    model, ps, wm, _alloc = _world("torch")
    save_dir = str(tmp_path / "nan_ck")
    runner = trun.Runner(model, ps, wm, max_epochs=100, max_iters=12)
    faults = tdyn.FaultInjectionHook(
        tdyn.FaultPlan([dict(iter=3, kind="nan", worker=1)]))
    runner.register_hook(faults)
    runner.register_hook(trun.NanGuardHook(action="raise"))
    runner.register_hook(trun.CheckpointHook(save_path=save_dir,
                                             save_interval=1))
    with pytest.raises(FloatingPointError, match="non-finite"):
        runner.train(_batches())
    # the poisoned step (iteration 3) is the fourth: it completes, then
    # the guard raises
    assert runner.aborted is True and runner.iter == 4
    assert [e["fired_at"] for e in faults.applied] == [3]
    assert not os.path.exists(save_dir) or os.listdir(save_dir) == []


def test_corrupt_checkpoint_fault_detected_on_load(tmp_path):
    model, ps, wm, _alloc = _world("torch")
    save_dir = str(tmp_path / "torn")
    runner = trun.Runner(model, ps, wm, max_epochs=1, max_iters=100)
    runner.register_hook(trun.CheckpointHook(save_path=save_dir,
                                             save_interval=1,
                                             save_training_state=True))
    runner.train(_batches(2))
    ckpt = osp.join(save_dir, "epoch_1.pt")
    assert osp.exists(ckpt) and osp.exists(ckpt + ".train_state.pt")
    size = osp.getsize(ckpt)
    target = tdyn.FaultPlan([], seed=11).corrupt_checkpoint(
        save_dir, keep_fraction=0.5)
    assert target == ckpt  # the params file, never its sidecar
    assert osp.getsize(ckpt) == size // 2
    ps2 = tdyn.ParameterServer(list(ps._model_config))
    with pytest.raises(ValueError, match="corrupt or truncated"):
        ps2.load_weights_from_file(ckpt)
    runner2 = trun.Runner(model, ps, wm, max_epochs=0, max_iters=0)
    runner2.register_hook(trun.CheckpointHook(load_checkpoint_from=ckpt))
    with pytest.raises(ValueError, match="corrupt or truncated"):
        runner2.train(_batches(1))


def test_drop_beat_with_no_heartbeat_is_recorded_unconsumed():
    model, ps, wm, _alloc = _world("torch")
    runner = trun.Runner(model, ps, wm, max_epochs=100, max_iters=4)
    faults = tdyn.FaultInjectionHook(
        tdyn.FaultPlan([dict(iter=1, kind="drop_beat")]))
    runner.register_hook(faults)
    runner.train(_batches())
    (drop,) = faults.applied
    assert drop["fired_at"] == 1 and drop["consumed"] is False
    assert runner.fault_drop_beat is False


# --- retry ----------------------------------------------------------------------

def test_retry_matches_the_reference_schedule():
    for args in ((4, 0.1, 1.0, 0.5, 7), (6, 0.05, 2.0, 0.25, 0)):
        assert tutils.backoff_delays(*args) == jutils.backoff_delays(*args)
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert tutils.retry_call(flaky, attempts=4, base_delay_s=0.1,
                             max_delay_s=1.0, jitter=0.5, seed=7,
                             sleep=sleeps.append) == "ok"
    assert sleeps == jutils.backoff_delays(4, 0.1, 1.0, 0.5, seed=7)[:2]

    def corrupt():
        raise ValueError("corrupt checkpoint")

    with pytest.raises(ValueError):
        tutils.retry_call(corrupt, attempts=5, sleep=lambda s: None)
