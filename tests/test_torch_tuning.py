"""The port's closed tuning loop (``skycomputing_tpu_torch/tuning``,
``AutotuneHook``, the engine's ``autotuner`` slot) against the JAX
package's, as ``tests/test_tuning.py`` runs it:

- the advisor's proposals equal the reference's on the same synthetic
  reports and on the repository's straggler fixture, exactly;
- under the same scripted advisor, ``AutotuneHook``'s outcome sequence
  (a rejected knob, a rollback with its spans and arc, an allocation
  the plan verifier vetoes with partition and calibration restored, an
  allocation applied and committed) equals the reference's, and so does
  ``ServingAutotuner``'s (a rejected bucket set, a rolled-back one, a
  committed slot count);
- the unscripted serving loop on a skewed bucket set proposes, applies
  and commits the same bucket as the reference, with the same padding
  figures, and every stream equals the reference engine's on the same
  weights (``params_from_jax``);
- a mid-flight ``reconfigure`` leaves every stream token-identical;
- ``bench_autotune --smoke`` passes, also loaded by file path with torch
  blocked, and its loop bench applies the straggler's re-allocation.

Host timing is kept out of every compared decision: the step-time judge
(``improved``) is patched to a fixed verdict where a window is judged on
wall time, and the serving loop judges padding, which counts tokens."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu import dynamics as jdyn
from skycomputing_tpu import runner as jrun
from skycomputing_tpu import serving as jserving
from skycomputing_tpu import telemetry as jtel
from skycomputing_tpu.analysis import plan_check as jplan
from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs
from skycomputing_tpu.ops import cross_entropy_loss as jax_ce
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu.telemetry import analysis as jax_analysis
from skycomputing_tpu.tuning import advisor as jax_advisor
from skycomputing_tpu.tuning import autotune as jax_autotune
from skycomputing_tpu_torch import dynamics as tdyn
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch import runner as trun
from skycomputing_tpu_torch import serving as tserving
from skycomputing_tpu_torch import telemetry as ttel
from skycomputing_tpu_torch.analysis import plan_check as tplan
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import PipelineModel, sgd
from skycomputing_tpu_torch.runner.hooks_collection import \
    autotune_hook as thook
from skycomputing_tpu_torch.telemetry import analysis
from skycomputing_tpu_torch.tools import bench_autotune
from skycomputing_tpu_torch.tuning import advisor, autotune
from torch_test_helpers import one_thread  # noqa: F401

import skycomputing_tpu.runner.hooks_collection.autotune_hook as jhook

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
STRAGGLER = str(REPO / "tools" / "fixtures" / "trace_straggler.json")


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    jtel.disable_tracing()
    ttel.disable_tracing()
    yield
    jtel.disable_tracing()
    ttel.disable_tracing()


# --- the advisor ----------------------------------------------------------

def _report(**serving):
    return {"stage_busy_ms": {"0": 50.0}, "bubble_fraction": 0.2,
            "serving": serving}


TAIL = dict(prefill_waves=10, decode_ticks=40, queue_stalls=0,
            tpot_p50_s=0.03, tpot_p95_s=0.60,
            buckets={"16": {"waves": 10, "requests": 10, "tokens": 150}})
BUBBLE = {"stage_busy_ms": {"0": 30.0, "1": 32.0}, "bubble_fraction": 0.55,
          "steps": {"count": 8, "p50_ms": 12.0}}
CLEAN = {"stage_busy_ms": {"0": 90.0, "1": 92.0, "2": 91.0},
         "bubble_fraction": 0.08, "steps": {"count": 10, "p50_ms": 10.0}}

#: (advisor kwargs, method, report, keyword arguments): the reference's
#: tests/test_tuning.py:69-237 cases
ADVICE = {
    "bubble_gpipe": ({}, "training", BUBBLE,
                     dict(schedule="gpipe", num_microbatches=4,
                          batch_size=8)),
    "bubble_1f1b": ({}, "training", BUBBLE,
                    dict(schedule="1f1b", num_microbatches=4,
                         batch_size=8)),
    "bubble_indivisible": ({}, "training", BUBBLE,
                           dict(schedule="1f1b", num_microbatches=4,
                                batch_size=12)),
    "clean": ({}, "training", CLEAN,
              dict(schedule="1f1b", num_microbatches=4, batch_size=8)),
    "skew": ({}, "serving", _report(
        prefill_waves=20, decode_ticks=80, queue_stalls=0,
        padding_fraction=1 - 200 / (64 * 20),
        buckets={"64": {"waves": 20, "requests": 20, "tokens": 200,
                        "padded_fraction": 0.84}}),
        dict(buckets=(64,), num_slots=4, max_len=128)),
    "stalls": ({}, "serving", _report(
        prefill_waves=10, decode_ticks=30, queue_stalls=25,
        buckets={"16": {"waves": 10, "requests": 10, "tokens": 150,
                        "padded_fraction": 0.06}}),
        dict(buckets=(16,), num_slots=2, max_len=64)),
    "healthy": ({}, "serving", _report(
        prefill_waves=10, decode_ticks=30, queue_stalls=0,
        buckets={"16": {"waves": 10, "requests": 10, "tokens": 150,
                        "padded_fraction": 0.06}}),
        dict(buckets=(16,), num_slots=2, max_len=64)),
    "tail_enable": (dict(tail_ratio_threshold=3.0), "serving",
                    _report(**TAIL),
                    dict(buckets=(16, 32, 64), num_slots=4, max_len=128,
                         prefill_chunk=None)),
    "tail_shrink": (dict(tail_ratio_threshold=3.0), "serving",
                    _report(**TAIL),
                    dict(buckets=(16, 32, 64), num_slots=4, max_len=128,
                         prefill_chunk=32)),
    "tail_floor": (dict(tail_ratio_threshold=3.0), "serving",
                   _report(**TAIL),
                   dict(buckets=(16, 32, 64), num_slots=4, max_len=128,
                        prefill_chunk=16)),
    "tail_blocked": (dict(tail_ratio_threshold=3.0), "serving",
                     _report(**TAIL),
                     dict(buckets=(16, 32, 64), num_slots=4, max_len=128,
                          blocked={advisor.DECODE_TAIL})),
    "tail_trace_only": (dict(tail_ratio_threshold=3.0), "serving", _report(
        **{k: v for k, v in TAIL.items() if not k.startswith("tpot_")}),
        dict(buckets=(16, 32, 64), num_slots=4, max_len=128)),
    "tail_calm": (dict(tail_ratio_threshold=3.0), "serving",
                  _report(**dict(TAIL, tpot_p95_s=0.05)),
                  dict(buckets=(16, 32, 64), num_slots=4, max_len=128)),
}


def _propose(module, ctor, method, report, kw):
    p = getattr(module.TuningAdvisor(**ctor), f"propose_{method}")(
        report, **kw)
    return None if p is None else p.describe()


@pytest.mark.parametrize("case", sorted(ADVICE))
def test_advisor_proposals_equal_jax(case):
    ctor, method, report, kw = ADVICE[case]
    want = _propose(jax_advisor, ctor, method, report, kw)
    assert _propose(advisor, ctor, method, report, kw) == want


@pytest.mark.parametrize("blocked", [(), ("straggler",),
                                     ("straggler", "pipeline_schedule",
                                      "microbatch_count")])
def test_straggler_fixture_proposals_equal_jax(blocked):
    got_report = analysis.analyze(analysis.load_events(STRAGGLER))
    want_report = jax_analysis.analyze(jax_analysis.load_events(STRAGGLER))
    kw = dict(schedule="gpipe", num_microbatches=2, batch_size=8,
              blocked=set(blocked))
    got = _propose(advisor, {}, "training", got_report, kw)
    want = _propose(jax_advisor, {}, "training", want_report, kw)
    assert got == want
    if not blocked:
        assert got["knob"] == "allocation" and got["value"] == [
            round(v, 6) for v in analysis.measured_stage_seconds(got_report)]


def test_advisor_validation_equals_jax():
    for kw in (dict(straggler_ratio=1.0), dict(tail_ratio_threshold=0.5)):
        with pytest.raises(ValueError) as want:
            jax_advisor.TuningAdvisor(**kw)
        with pytest.raises(ValueError) as got:
            advisor.TuningAdvisor(**kw)
        assert str(got.value) == str(want.value)


# --- AutotuneHook under a scripted advisor ---------------------------------

class _Scripted:
    """Returns the queued proposals once each (skipping blocked ones),
    then None."""

    def __init__(self, proposals):
        self._proposals = list(proposals)

    def _next(self, blocked):
        while self._proposals:
            p = self._proposals.pop(0)
            if p.signature not in blocked:
                return p
        return None

    def propose_training(self, report, *, blocked=(), **_):
        return self._next(blocked)

    def propose_serving(self, report, *, blocked=(), **_):
        return self._next(blocked)


def _bert_world(pkg, devices, n_workers=2, units=2, slowdowns=None):
    """(model, allocator, wm, ps, batch) of one package: the reference's
    tuning world (tiny BERT, static homogeneous profiles, even)."""
    dyn = jdyn if pkg == "jax" else tdyn
    if pkg == "jax":
        cfg = jax_bert_config("tiny", dtype="float32",
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
        mc = jax_bert_layers(cfg, num_encoder_units=units, num_classes=3,
                             deterministic=True)
    else:
        cfg = bert_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        mc = bert_layer_configs(cfg, num_encoder_units=units,
                                num_classes=3, deterministic=True)
    wm = dyn.WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"n{i}", device_config=dict(device_index=i),
             extra_config=dict(slowdown=slowdowns[i] if slowdowns else 1.0))
        for i in range(n_workers)])

    class _Dev:
        def benchmark(self):
            return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                    for w in wm.worker_pool}

    class _Mod:
        def benchmark(self):
            return [1.0] * len(mc), [0.1] * len(mc)

    allocator = dyn.Allocator(mc, wm, _Mod(), _Dev())
    allocator.even_allocate()
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 1024, size=(8, 16)).astype(np.int32)
    types, mask = np.zeros_like(ids), np.ones_like(ids)
    labels = rng.integers(0, 3, size=(8,)).astype(np.int32)
    if pkg == "jax":
        ps = dyn.ParameterServer(mc, example_inputs=(ids, types, mask),
                                 rng=jax.random.key(0))
        model = JaxPipelineModel(wm, ps, optax.sgd(1e-2), jax_ce,
                                 devices=devices[:n_workers],
                                 num_microbatches=2)
        batch = ((ids, types, mask), labels)
    else:
        ps = dyn.ParameterServer(
            mc, generator=torch.Generator().manual_seed(0))
        model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                              devices=[torch.device("cpu")],
                              num_microbatches=2)
        batch = (tuple(torch.from_numpy(x.astype(np.int64))
                       for x in (ids, types, mask)),
                 torch.from_numpy(labels.astype(np.int64)))
    return model, allocator, wm, ps, batch


def _train(pkg, devices, proposals, iters, monkeypatch, *, verdict=None,
           veto=False, allocator_wired=False, preflight=True):
    """One package's run: returns (hook, model, wm, allocator, runner,
    trace events, the partition before the run)."""
    hook_mod, plan, run, tel = ((jhook, jplan, jrun, jtel) if pkg == "jax"
                                else (thook, tplan, trun, ttel))
    tuning_mod = (jax_advisor if pkg == "jax" else advisor)
    if verdict is not None:
        monkeypatch.setattr(hook_mod, "improved",
                            lambda *a, **k: verdict)
    if veto:
        def _veto(*args, **kwargs):
            return plan.PlanReport(issues=[
                plan.PlanIssue("memory", "error", "scripted veto")])

        monkeypatch.setattr(plan, "verify_plan", _veto)
    model, allocator, wm, ps, batch = _bert_world(pkg, devices)
    before = [list(w.model_config) for w in wm.worker_pool]
    ps_proposals = [tuning_mod.Proposal(**p) for p in proposals]
    hook = run.AutotuneHook(
        allocator=allocator if allocator_wired else None,
        advisor=_Scripted(ps_proposals), tune_every=2, solver_time_s=1.0)
    tracer = tel.enable_tracing()
    runner = run.Runner(model, ps, wm, max_epochs=1, max_iters=iters,
                        preflight=preflight)
    runner.register_hook(hook)
    runner.train([batch] * iters)
    return (hook, model, wm, allocator, runner,
            tracer.to_chrome()["traceEvents"], before)


def _outcomes(hook):
    keep = ("outcome", "iter", "epoch", "proposal", "error")
    return [{k: e[k] for k in keep if k in e} for e in hook.events]


def _arcs(events):
    return [ev["args"].get("outcome") for ev in events
            if ev.get("ph") == "e" and ev.get("name") == "autotune"]


def _spans(events):
    return sorted({ev["name"] for ev in events if ev.get("ph") == "X"
                   and ev["name"].startswith("autotune.")})


def _both(devices, monkeypatch, **kw):
    out = {}
    for pkg in ("jax", "torch"):
        with monkeypatch.context() as m:
            out[pkg] = _train(pkg, devices, monkeypatch=m, **kw)
    return out


def test_rejected_knob_outcomes_equal_jax(devices, monkeypatch):
    bad = dict(knob="microbatches", value=7, signature="bad_mb",
               metric="step_p50_ms", reason="scripted")
    runs = _both(devices, monkeypatch, proposals=[bad], iters=6)
    (jh, jm, *_), (th, tm, *_) = runs["jax"], runs["torch"]
    assert _outcomes(th) == _outcomes(jh)
    assert [e["outcome"] for e in th.events] == [
        "warmup", "rejected", "no_op"]
    assert "does not divide" in th.events[1]["error"]
    assert tm.num_microbatches == jm.num_microbatches == 2
    assert th.blocked == jh.blocked == {"bad_mb"}
    assert _arcs(runs["torch"][5]) == _arcs(runs["jax"][5]) == ["rejected"]


def test_rollback_outcomes_and_spans_equal_jax(devices, monkeypatch):
    flip = dict(knob="schedule", value="1f1b", signature="flip",
                metric="step_p50_ms", reason="scripted")
    runs = _both(devices, monkeypatch, proposals=[flip], iters=8,
                 verdict=False)
    (jh, jm, *_), (th, tm, *_) = runs["jax"], runs["torch"]
    assert _outcomes(th) == _outcomes(jh)
    assert [e["outcome"] for e in th.events] == [
        "warmup", "applied", "rolled_back", "no_op"]
    assert tm.schedule == jm.schedule == "gpipe"
    assert th.blocked == jh.blocked == {"flip"}
    assert _spans(runs["torch"][5]) == _spans(runs["jax"][5])
    assert {"autotune.analyze", "autotune.apply",
            "autotune.rollback"} <= set(_spans(runs["torch"][5]))
    assert _arcs(runs["torch"][5]) == _arcs(runs["jax"][5]) == [
        "rolled_back"]


def test_allocation_veto_restores_partition_and_calibration(
        devices, monkeypatch):
    straggle = dict(knob="allocation", value=[0.3, 0.1],
                    signature="straggler", metric="step_p50_ms",
                    reason="scripted")
    runs = _both(devices, monkeypatch, proposals=[straggle], iters=6,
                 veto=True, allocator_wired=True, preflight=False)
    for pkg in ("jax", "torch"):
        hook, model, wm, allocator, _, _, before = runs[pkg]
        assert [list(w.model_config) for w in wm.worker_pool] == before
        assert allocator.snapshot_calibration() == {"cost": None,
                                                    "speed": {}}
    jh, th = runs["jax"][0], runs["torch"][0]
    assert _outcomes(th) == _outcomes(jh)
    assert [e["outcome"] for e in th.events] == [
        "warmup", "rejected", "no_op"]
    assert "scripted veto" in th.events[1]["error"]
    assert [len(w.model_config) for w in runs["torch"][2].worker_pool] == \
        [len(w.model_config) for w in runs["jax"][2].worker_pool]


def test_allocation_commit_equals_jax(devices, monkeypatch):
    """A straggler re-allocation verified, applied through the rebuild
    path, pre-flighted again and committed: the same new partition in
    both packages."""
    straggle = dict(knob="allocation", value=[0.3, 0.1],
                    signature="straggler", metric="step_p50_ms",
                    reason="scripted")
    runs = _both(devices, monkeypatch, proposals=[straggle], iters=8,
                 verdict=True, allocator_wired=True)
    (jh, jm, *_), (th, tm, _, talloc, trunner, tev, _) = (runs["jax"],
                                                           runs["torch"])
    assert _outcomes(th) == _outcomes(jh)
    assert [e["outcome"] for e in th.events] == [
        "warmup", "applied", "committed", "no_op"]
    assert th.tunes == jh.tunes == 1
    assert tm.partition_signature() == jm.partition_signature()
    assert tm.partition_signature() != [2, 2]
    assert talloc.snapshot_calibration()["speed"]
    # the rebuilt plan passed the Runner's pre-flight before its first step
    assert [r.ok for r in trunner.preflight_reports] == [True, True]
    assert _arcs(tev) == ["committed"]


def test_unsupported_model_disarms_like_jax():
    class _Bare:
        pass

    hooks = [pkg.AutotuneHook() for pkg in (jrun, trun)]

    class _Runner:
        model = _Bare()

        class logger:
            @staticmethod
            def info(msg):
                pass

    for hook in hooks:
        hook.before_run(_Runner())
        hook.after_run(_Runner())
    assert hooks[1].events == hooks[0].events == [
        dict(outcome="unsupported_model", model="_Bare")]
    with pytest.raises(ValueError) as want:
        jrun.AutotuneHook(tune_every=1)
    with pytest.raises(ValueError) as got:
        trun.AutotuneHook(tune_every=1)
    assert str(got.value) == str(want.value)


# --- serving ----------------------------------------------------------------

def _gpt():
    cfg = GptConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=64,
                    dropout_prob=0.0, dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(0),
                                        np.ones((1, 5), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs)


@pytest.fixture(scope="module")
def gpt():
    return _gpt()


def _engine(pkg, gpt, **kw):
    layer_cfgs, params, sds = gpt
    if pkg == "jax":
        return jserving.ServingEngine(layer_cfgs, list(params), **kw)
    return tserving.ServingEngine(layer_cfgs, sds, device="cpu", **kw)


def _requests(pkg, lengths, max_new_tokens=4, seed=3):
    Request = (jserving if pkg == "jax" else tserving).Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 256, (n,)).astype(np.int32),
                    max_new_tokens=max_new_tokens) for n in lengths]


LENGTHS = [5, 7, 6, 9, 5, 8, 6, 7, 5, 6, 9, 7]


def test_serving_autotuner_fixes_skewed_buckets_like_jax(gpt):
    """The reference's E2E-lite: one oversized bucket; the attached tuner
    reads its own trace, proposes a tighter bucket, reconfigures and
    commits after padding waste drops — the same events (padding
    figures included) in both packages, the same streams."""
    out = {}
    for pkg in ("jax", "torch"):
        tel, tune = ((jtel, jax_autotune) if pkg == "jax"
                     else (ttel, autotune))
        engine = _engine(pkg, gpt, num_slots=2, max_len=64, buckets=(48,),
                         prefill_batch=1)
        tuner = tune.ServingAutotuner(engine, tune_every=10, max_tunes=2,
                                      min_improvement=0.05)
        assert engine.autotuner is tuner
        tracer = tel.enable_tracing()
        try:
            reqs = _requests(pkg, LENGTHS, max_new_tokens=5)
            engine.run(reqs)
        finally:
            tel.disable_tracing()
        out[pkg] = (tuner, engine, [list(r.tokens) for r in reqs],
                    tracer.to_chrome()["traceEvents"])
    (jt, je, jstreams, _), (tt, te, tstreams, tev) = out["jax"], out[
        "torch"]
    assert tstreams == jstreams
    assert [(e["outcome"], e["step"], e.get("proposal"))
            for e in tt.events] == [(e["outcome"], e["step"],
                                     e.get("proposal")) for e in jt.events]
    for got, want in zip(tt.events, jt.events):
        for key in ("base", "new"):
            if key in want:
                assert got[key] == pytest.approx(want[key], abs=1e-12)
    applied = next(e for e in tt.events if e["outcome"] == "applied")
    assert applied["proposal"]["signature"] == advisor.SKEWED_BUCKETS
    assert "committed" in [e["outcome"] for e in tt.events]
    assert te.bucketer.buckets == je.bucketer.buckets
    assert min(te.bucketer.buckets) < 48
    names = {ev["name"] for ev in tev if ev["ph"] in ("X", "i")}
    assert {"autotune.analyze", "autotune.apply", "reconfigure"} <= names


SCRIPTED_SERVING = {
    # a bucket past the slab fails the knob verifier: rejected, blocked
    "reject": ([dict(knob="buckets", value=(16, 128), signature="big",
                     metric="stall_fraction", reason="scripted")], None),
    # a valid bucket set whose window does not improve: rolled back
    "rollback": ([dict(knob="buckets", value=(8, 16), signature="tight",
                       metric="stall_fraction", reason="scripted")],
                 False),
    # a slot proposal committed on a forced verdict
    "commit": ([dict(knob="slots", value=4, signature="slots",
                     metric="stall_fraction", reason="scripted")], True),
}


@pytest.mark.parametrize("case", sorted(SCRIPTED_SERVING))
def test_serving_outcomes_equal_jax(gpt, monkeypatch, case):
    proposals, verdict = SCRIPTED_SERVING[case]
    out = {}
    for pkg in ("jax", "torch"):
        tel, tune, adv = ((jtel, jax_autotune, jax_advisor) if pkg == "jax"
                          else (ttel, autotune, advisor))
        with monkeypatch.context() as m:
            if verdict is not None:
                m.setattr(tune, "improved", lambda *a, **k: verdict)
            engine = _engine(pkg, gpt, num_slots=2, max_len=48,
                             buckets=(16,), prefill_batch=1)
            tuner = tune.ServingAutotuner(
                engine, advisor=_Scripted(
                    [adv.Proposal(**p) for p in proposals]),
                tune_every=4, max_tunes=2)
            tel.enable_tracing()
            try:
                reqs = _requests(pkg, LENGTHS[:8], max_new_tokens=6)
                engine.run(reqs)
            finally:
                tel.disable_tracing()
        out[pkg] = (tuner, engine, [list(r.tokens) for r in reqs])
    (jt, je, js), (tt, te, ts) = out["jax"], out["torch"]
    keep = ("outcome", "step", "proposal")
    assert [{k: e[k] for k in keep if k in e} for e in tt.events] == [
        {k: e[k] for k in keep if k in e} for e in jt.events]
    assert tt.blocked == jt.blocked
    assert ts == js
    assert te.bucketer.buckets == je.bucketer.buckets
    assert te.num_slots == je.num_slots
    outcomes = [e["outcome"] for e in tt.events]
    expect = {"reject": "rejected", "rollback": "rolled_back",
              "commit": "committed"}[case]
    assert expect in outcomes


def test_window_slo_merge_and_chunk_actuation_equal_jax(gpt):
    """The decode-tail signature's input (the window's TPOT percentiles
    merged into the serving section) and its actuator
    (``reconfigure(prefill_chunk=...)``) on a paged engine."""
    got = {}
    for pkg in ("jax", "torch"):
        tune = jax_autotune if pkg == "jax" else autotune
        engine = _engine(pkg, gpt, num_slots=2, max_len=48, buckets=(8, 16),
                         kv_layout="paged", page_size=8)
        tuner = tune.ServingAutotuner(engine)
        engine.stats.tpot_s.extend([0.03, 0.031, 0.029, 0.030, 0.9])
        report = {"serving": {"prefill_waves": 1, "decode_ticks": 4,
                              "queue_stalls": 0, "buckets": {}}}
        tuner._merge_window_slo(report, engine)
        engine.reconfigure(prefill_chunk=8)
        chunk = engine.prefill_chunk
        engine.reconfigure(prefill_chunk=0)
        got[pkg] = (report, tuner._metric(report, "tpot_tail_ratio"),
                    chunk, engine.prefill_chunk)
    assert got["torch"] == got["jax"]
    assert got["torch"][2:] == (8, None)


def test_reconfigure_preserves_token_streams(gpt):
    """Mid-flight reconfiguration (a new bucket set AND slot count) is
    token-identical to an untouched engine and to the reference's
    reconfigured engine."""
    streams = {}
    for pkg in ("jax", "torch"):
        untouched = _engine(pkg, gpt, num_slots=2, max_len=48,
                            buckets=(16,))
        reqs_a = _requests(pkg, [5, 9, 12, 7])
        untouched.run(reqs_a)
        engine = _engine(pkg, gpt, num_slots=2, max_len=48, buckets=(16,))
        reqs_b = _requests(pkg, [5, 9, 12, 7])
        for r in reqs_b:
            engine.submit(r)
        for _ in range(3):  # some running, some queued
            engine.step()
        engine.reconfigure(buckets=(8, 16), num_slots=4)
        assert engine.free_slots >= 2
        engine.run()
        assert [list(r.tokens) for r in reqs_b] == [
            list(r.tokens) for r in reqs_a]
        assert tuple(engine.bucketer.buckets) == (8, 16)
        assert engine.num_slots == 4
        streams[pkg] = [list(r.tokens) for r in reqs_b]
    assert streams["torch"] == streams["jax"]


# --- the bench --------------------------------------------------------------

def test_bench_autotune_smoke():
    assert bench_autotune.run_smoke() == 0


def test_bench_autotune_smoke_loads_with_torch_blocked():
    script = (
        "import importlib.abc, runpy, sys\n"
        "class B(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in {'torch', 'numpy', 'jax',\n"
        "                'skycomputing_tpu', 'skycomputing_tpu_torch'}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "sys.argv = ['bench_autotune', '--smoke']\n"
        f"runpy.run_path({str(Path(bench_autotune.__file__))!r}, "
        "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr
    assert "# smoke: ok" in proc.stdout


def test_bench_autotune_loop_applies_the_straggler_proposal():
    """The loop bench's world (3 workers, worker 0 at slowdown 3) on the
    CPU: the trace's straggler signature becomes an ``allocation``
    proposal applied through the rebuild path and settled on the next
    window (committed or rolled back: that verdict is the host's step
    time, which other test workers share)."""
    result = bench_autotune.run_bench(24, device="cpu")
    outcomes = [e["outcome"] for e in result["events"]]
    assert "applied" in outcomes, result["events"]
    assert result["proposals"][0]["signature"] == advisor.STRAGGLER
    assert outcomes[outcomes.index("applied") + 1] in (
        "committed", "rolled_back")
    assert result["partition_before"] == [4, 4, 4]


# slow, as the reference's soak (tests/test_tuning.py:522): the whole
# loop on real step times, a 3x-slowed worker, and the regression gate
@pytest.mark.slow
def test_autotuner_converges_on_straggler_world(devices, tmp_path):
    """No human in the loop: the hook reads the trace, re-solves the
    allocation through the verifier, applies it via the rebuild path,
    and a fresh traced run on the tuned plan passes
    ``trace_report --baseline`` against the pre-tune step time."""
    import json

    from skycomputing_tpu_torch.runner import TraceHook
    from skycomputing_tpu_torch.tools import trace_report

    model, allocator, wm, ps, batch = _bert_world(
        "torch", devices, n_workers=3, units=3, slowdowns=[3.0, 1.0, 1.0])
    even = model.partition_signature()
    hook = trun.AutotuneHook(allocator=allocator, tune_every=5,
                             min_improvement=0.02, solver_time_s=2.0)
    runner = trun.Runner(model, ps, wm, max_epochs=1, max_iters=30)
    runner.register_hook(hook)
    runner.train([batch] * 30)
    applied = [e for e in hook.events if e["outcome"] == "applied"]
    committed = [e for e in hook.events if e["outcome"] == "committed"]
    assert applied and applied[0]["proposal"]["signature"] == \
        advisor.STRAGGLER, hook.events
    assert hook.tunes >= 1, hook.events
    assert model.partition_signature() != even
    slow = next(w for w in wm.worker_pool
                if w.extra_config.get("slowdown") == 3.0)
    assert len(slow.model_config) < max(len(w.model_config)
                                        for w in wm.worker_pool)
    assert committed[-1]["new_ms"] < applied[0]["base_ms"]
    baseline = tmp_path / "pre_tune.json"
    baseline.write_text(json.dumps(
        {"summary": {"step_ms": applied[0]["base_ms"]}}))
    trace = str(tmp_path / "tuned.trace.json")
    again = trun.Runner(model, ps, wm, max_epochs=1, max_iters=8)
    again.register_hook(trun.TraceHook(trace))
    again.train([batch] * 8)
    assert trace_report.main([trace, "--baseline", str(baseline)]) == 0
