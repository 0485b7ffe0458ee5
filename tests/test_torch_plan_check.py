"""The port's pre-flight plan verifier against the JAX package's
(``analysis/plan_check.py``): on the fixtures of ``tests/test_analysis``
(``MatmulStack`` units, the ``Conv2d`` boundary, good, short, shuffled,
over-memory, warned, wrong-length ``layer_mem``, ``param_scale`` and
donation-only plans, and BERT ``tiny`` units over two stages) both
packages accept and reject the same plans, with equal checks, equal
``(code, severity)`` lists and equal messages up to the exception text
of a shape diagnostic (the framework's own).  The port's ``Runner``
keeps the reference's contracts: a tampered plan is rejected before
the first step and not latched, the opt-out works, and
``rearm_preflight`` verifies again; every unit type differentiates on
``meta`` for the donation check."""

import re

import numpy as np
import pytest
import torch

from skycomputing_tpu.analysis import plan_check as jpc
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu_torch.analysis import PlanError
from skycomputing_tpu_torch.analysis import plan_check as tpc
from skycomputing_tpu_torch.dynamics import ParameterServer, WorkerManager
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import PipelineModel, sgd
from skycomputing_tpu_torch.registry import LAYER
from skycomputing_tpu_torch.runner import Runner

pytestmark = pytest.mark.torch_port

N_UNITS = 8
X = np.ones((4, 32), np.float32)


def _mm_cfg(features=32):
    return [dict(layer_type="MatmulStack", features=features, depth=2)
            for _ in range(N_UNITS)]


def _shuffle_cfg():
    return [dict(layer_type="MatmulStack", features=16 + i, depth=1)
            for i in range(N_UNITS)]


def _conv_cfg():
    return [dict(layer_type="MatmulStack", features=32, depth=1),
            dict(layer_type="Conv2d", in_channels=3, out_channels=4)]


def _bert_inputs(batch=2, seq=8):
    ids = np.random.default_rng(0).integers(
        5, 100, size=(batch, seq)).astype(np.int32)
    return (ids, np.zeros_like(ids), np.ones_like(ids))


def _pool(wm_cls, slices, mem_limit=None):
    """A worker per slice of ``slices`` (lists of layer configs)."""
    wm = wm_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"n{i}", device_config=dict(device_index=0),
             extra_config=(dict(mem_limit=mem_limit)
                           if mem_limit is not None else {}))
        for i in range(len(slices))])
    for w, part in zip(wm.worker_pool, slices):
        w.model_config = part
        w.order = w.rank + 1
    return wm


def _counts(cfg, counts):
    out, cursor = [], 0
    for c in counts:
        out.append(cfg[cursor:cursor + c])
        cursor += c
    return out


# name -> (model config maker, slices maker, inputs, mem_limit, kwargs)
CASES = {
    "good_332": (_mm_cfg, lambda c: _counts(c, [3, 3, 2]), X, None, {}),
    "short_331": (_mm_cfg, lambda c: _counts(c, [3, 3, 1]), X, None, {}),
    "shuffled": (_shuffle_cfg, lambda c: [c[4:], c[:4]],
                 np.ones((4, 16), np.float32), None, {}),
    "over_memory": (_mm_cfg, lambda c: _counts(c, [4, 4]), X, 0.01,
                    dict(memory="error")),
    "over_memory_warn": (_mm_cfg, lambda c: _counts(c, [4, 4]), X, 0.01,
                         dict(memory="warn")),
    "layer_mem_short_warn": (
        _mm_cfg, lambda c: _counts(c, [3, 3, 2]), X, 1000.0,
        dict(layer_mem=[0.1] * (N_UNITS - 2), memory="warn")),
    "layer_mem_short_error": (
        _mm_cfg, lambda c: _counts(c, [3, 3, 2]), X, None,
        dict(layer_mem=[0.1] * (N_UNITS - 2), memory="error")),
    "param_scale_2": (_mm_cfg, lambda c: _counts(c, [4, 4]), X, 0.5,
                      dict(memory="error", param_scale=2)),
    "param_scale_100": (_mm_cfg, lambda c: _counts(c, [4, 4]), X, 0.5,
                        dict(memory="error", param_scale=100)),
    "donation_only": (_mm_cfg, lambda c: _counts(c, [3, 3, 2]), X, None,
                      dict(layer_mem=[0.1] * N_UNITS, check_shapes=False,
                           check_donation=True)),
    "conv_boundary": (_conv_cfg, lambda c: [c[:1], c[1:]], X, None, {}),
}

_TAIL = re.compile(r"(produced by layer \S+: )\w+: .*$")


def _comparable(report):
    """(ok, checks, [(code, severity)], messages less a shape
    diagnostic's exception text)."""
    return (report.ok, list(report.checks),
            [(i.code, i.severity) for i in report.issues],
            [_TAIL.sub(r"\1<exception>", i.message) for i in report.issues])


def _both(case):
    make_cfg, make_slices, inputs, mem_limit, kwargs = CASES[case]
    reports = []
    for pc, wm_cls in ((jpc, JaxWorkerManager), (tpc, WorkerManager)):
        cfg = make_cfg()
        wm = _pool(wm_cls, make_slices(cfg), mem_limit)
        reports.append(pc.verify_plan(cfg, wm, (inputs,), **kwargs))
    return reports


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_reports_match_the_reference(case):
    want, got = _both(case)
    assert _comparable(got) == _comparable(want)
    assert (got.stages, got.layers) == (want.stages, want.layers)
    if case == "good_332":
        assert got.ok and got.checks == ["coverage", "shapes", "memory",
                                         "donation"]
    if case in ("over_memory", "param_scale_100"):
        # the MB figures: need, budget and ratio, as the reference prints
        assert "MB but its budget is" in got.issues[0].message
        assert not got.ok
    if case == "conv_boundary":
        assert got.issues[0].message.startswith(
            "layer 1 (Conv2d, worker rank 1) rejects the boundary "
            "signature [(4, 32):bfloat16] produced by layer 0: ")


def test_bert_tiny_two_stage_plan_matches_the_reference():
    data = _bert_inputs()
    reports = []
    for pc, wm_cls, cfg_fn, layers_fn in (
            (jpc, JaxWorkerManager, jax_bert_config, jax_bert_layers),
            (tpc, WorkerManager, bert_config, bert_layer_configs)):
        cfg = layers_fn(cfg_fn("tiny", dtype="float32"),
                        num_encoder_units=2, deterministic=True)
        wm = _pool(wm_cls, _counts(cfg, [4, len(cfg) - 4]), 50.0)
        reports.append(pc.verify_plan(cfg, wm, data, memory="error"))
        # a unit's config dropped from the second stage: coverage
        wm.worker_pool[1].model_config = cfg[5:]
        reports.append(pc.verify_plan(cfg, wm, data))
    (jgood, jbad), (tgood, tbad) = reports[:2], reports[2:]
    assert _comparable(tgood) == _comparable(jgood)
    assert tgood.ok and "donation" in tgood.checks
    assert _comparable(tbad) == _comparable(jbad)
    assert not tbad.ok and tbad.errors[0].code == "coverage"


def test_layer_trace_cache_dedupes_across_splits():
    tpc.verify_plan(_mm_cfg(), _pool(WorkerManager,
                                     _counts(_mm_cfg(), [3, 3, 2])), (X,))
    entries = len(tpc._LAYER_TRACE_CACHE)
    assert entries > 0
    tpc.verify_plan(_mm_cfg(), _pool(WorkerManager,
                                     _counts(_mm_cfg(), [2, 3, 3])), (X,))
    assert len(tpc._LAYER_TRACE_CACHE) == entries
    assert tpc._exc_line(ValueError()) == "(no message)"
    assert tpc._exc_line(ValueError("boom\nmore")) == "boom"


def test_serving_context_counts_kv_memory():
    """The reference's ``test_serving_kv_memory_failure_names_context``,
    replayed on both packages: per-layer KV slabs of 1 MB blow a 1.5 MB
    budget the bare units fit, and the diagnostic names the serving
    operating point; without the context the plan passes."""
    cfg = _mm_cfg()
    serving = dict(slots=32, max_len=128, bucket=64,
                   kv_mb_per_layer=[1.0] * N_UNITS)
    reports = [
        pc.verify_plan(cfg, _pool(manager, _counts(cfg, [4, 4]),
                                  mem_limit=1.5), (X,), memory="error",
                       serving=dict(serving))
        for pc, manager in ((tpc, WorkerManager), (jpc, JaxWorkerManager))]
    assert reports[0].checks == reports[1].checks
    assert [(i.code, i.severity, i.message) for i in reports[0].issues] == [
        (i.code, i.severity, i.message) for i in reports[1].issues]
    msg = reports[0].errors[0].message
    assert "32 KV slots x max_len 128, bucket 64" in msg
    assert "KV slabs are 4 MB of the need" in msg
    assert tpc.verify_plan(cfg, _pool(WorkerManager, _counts(cfg, [4, 4]),
                                      mem_limit=1.5), (X,)).ok


class _NoMetaBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, dy):
        raise RuntimeError("no backward on this device")


@LAYER.register_module(name="PlanCheckNoBackward")
class _NoBackward(torch.nn.Module):
    def forward(self, x):
        return _NoMetaBackward.apply(x)


def test_a_unit_without_a_backward_is_a_donation_error():
    cfg = [dict(layer_type="MatmulStack", features=32, depth=1,
                dtype="float32"),
           dict(layer_type="PlanCheckNoBackward")]
    report = tpc.verify_plan(cfg, _pool(WorkerManager, [cfg[:1], cfg[1:]]),
                             (X,))
    assert not report.ok
    (issue,) = report.errors
    assert issue.code == "donation"
    assert issue.message == (
        "stage 1 (worker rank 1): backward does not abstractly evaluate: "
        "RuntimeError: no backward on this device")


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_every_unit_type_differentiates_on_meta(flash):
    """The donation check's backward runs through every unit of the
    registry (BERT's units with flash on and off, ``MatmulStack``,
    ``Conv2d``) on ``meta``, each float input getting a gradient of its
    own shape and dtype."""
    cfg = bert_layer_configs(
        bert_config("tiny", dtype="bfloat16", use_flash_attention=flash),
        num_encoder_units=1, ffn_shards=2)
    cfg += [dict(layer_type="MatmulStack", features=32, depth=2),
            dict(layer_type="Conv2d", in_channels=3, out_channels=4)]
    avals = tpc._avals(_bert_inputs())
    seen = set()
    for unit in cfg:
        if unit["layer_type"] == "MatmulStack":
            avals = tpc._avals((X,))
        elif unit["layer_type"] == "Conv2d":
            avals = tpc._avals((np.ones((2, 3, 8, 8), np.float32),))
        out, _parts, module = tpc._trace_layer(unit, avals)
        grads = tpc._trace_layer_cotangents(module, avals)
        for a, g in zip(avals, grads):
            if g is not None:  # None: an input the unit does not use
                assert (tuple(g.shape), g.dtype) == (tuple(a.shape),
                                                     a.dtype)
        if avals[0].dtype.is_floating_point:
            assert grads[0] is not None, unit["layer_type"]
        seen.add(unit["layer_type"])
        avals = out
    assert {"BertEmbeddings", "BertLayer_Head", "BertLayer_BodyShard",
            "BertLayer_Tail", "BertPooler", "BertTailForClassification",
            "MatmulStack", "Conv2d"} <= seen


# --- the Runner's pre-flight -------------------------------------------------

def _build(counts=(3, 3, 2)):
    cfg = _mm_cfg()
    wm = _pool(WorkerManager, _counts(cfg, counts))
    ps = ParameterServer(cfg)
    model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                          devices=[torch.device("cpu")])
    return model, ps, wm


LABELS = np.zeros((4,), np.int32)


def test_runner_preflight_rejects_a_tampered_plan_and_does_not_latch():
    model, ps, wm = _build()
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=1)
    kept = wm.worker_pool[0].model_config
    wm.worker_pool[0].model_config = kept[:2]
    with pytest.raises(PlanError, match="coverage"):
        runner.train([((X,), LABELS)])
    assert runner.iter == 0
    # not latched: the still-broken plan is verified again, and a fix
    # made outside rearm_preflight is picked up
    with pytest.raises(PlanError, match="coverage"):
        runner.train([((X,), LABELS)])
    wm.worker_pool[0].model_config = kept
    runner.train([((X,), LABELS)])
    assert runner.iter == 1
    assert [r.ok for r in runner.preflight_reports] == [False, False, True]


def test_runner_preflight_opt_out(monkeypatch):
    for kwargs, env in ((dict(preflight=False), None),
                        ({}, "0")):
        if env is not None:
            monkeypatch.setenv("SKYTPU_PREFLIGHT", env)
        model, ps, wm = _build()
        runner = Runner(model, ps, wm, max_epochs=1, max_iters=1, **kwargs)
        wm.worker_pool[0].model_config = wm.worker_pool[0].model_config[:2]
        runner.train([((X,), LABELS)])  # not caught up front
        assert runner.iter == 1 and runner.preflight_reports == []


def test_rearm_preflight_verifies_again():
    """A hook that changes the plan mid-run and re-arms the pre-flight
    (as ``SelfHealHook`` does after its rebuild) gets it verified before
    the next step."""
    from skycomputing_tpu_torch.runner import Hook

    class Tamper(Hook):
        def after_train_iter(self, runner):
            if runner.iter == 1:
                w = runner.worker_manager.worker_pool[0]
                w.model_config = w.model_config[:2]
                runner.rearm_preflight()

    model, ps, wm = _build()
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=3)
    runner.register_hook(Tamper())
    with pytest.raises(PlanError, match="coverage"):
        runner.train([((X,), LABELS)] * 3)
    assert runner.iter == 1
    assert [r.ok for r in runner.preflight_reports] == [True, False]
