"""Evaluation on the port against the JAX package, on the CPU: BERT
``tiny`` at 2 encoder layers over 3 pipeline workers, flash attention on
(its plain version) and off, the same weights in both packages
(``params_from_jax``) and the same numpy batches (a ragged last one):
``Runner.evaluate``'s loss within 1e-5 relative, equal accuracy and task
metrics (mnli, mrpc, cola); the loss weighted per example; shifted-token
accuracy on 3-D logits; ``EvalHook`` and ``MetricsHook`` records (the
``run_start`` header, its ``config_hash`` equal to the JAX hook's, the
flush cadence); ``NanGuardHook`` and ``WatchdogHook`` as in
``tests/test_failure_detection.py``; and ``ops/metrics.py`` equal to the
JAX package's on seeded predictions."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.ops import metrics as jmetrics
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu.runner import MetricsHook as JaxMetricsHook
from skycomputing_tpu.runner import Runner as JaxRunner
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.builder import build_hook
from skycomputing_tpu_torch.dataset import DataLoader, RandomBertDataset
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.launch import BatchAdapter
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops import losses as tlosses
from skycomputing_tpu_torch.ops import metrics as tmetrics
from skycomputing_tpu_torch.parallel import PipelineModel, sgd
from skycomputing_tpu_torch.runner import (
    EvalHook,
    Hook,
    MetricsHook,
    NanGuardHook,
    Runner,
    WatchdogHook,
)
from skycomputing_tpu_torch.runner.hooks_collection import watchdog_hook

pytestmark = pytest.mark.torch_port

CPU = [torch.device("cpu")]
SEQ = 16


def _model_cfg(flash, num_classes=3):
    cfg = bert_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=flash)
    return bert_layer_configs(cfg, num_encoder_units=2,
                              num_classes=num_classes, deterministic=True)


def _pool(manager_cls, n_workers=3):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n_workers)])
    return wm


def _batches(num_classes, sizes=(8, 8, 5), seed=0):
    """Batches in the model's order (ids, token types, mask), padded
    tails, the last batch short."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        ids = rng.integers(5, 1024, size=(n, SEQ)).astype(np.int32)
        lengths = rng.integers(4, SEQ + 1, size=(n,))
        mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
        types = (np.arange(SEQ)[None, :] >= lengths[:, None] // 2).astype(
            np.int32) * mask
        labels = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
        out.append(((ids * mask, types, mask), labels))
    return out


def _port_world(model_cfg, state_dicts=None, seed=0):
    wm = _pool(WorkerManager)
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(seed))
    model = PipelineModel(wm, ps, sgd(1e-2), tlosses.cross_entropy_loss,
                          devices=CPU)
    return model, ps, wm


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "einsum"])
@pytest.mark.parametrize("task,num_classes", [
    ("mnli", 3), ("mrpc", 2), ("cola", 2)])
def test_evaluate_matches_jax(devices, task, num_classes, flash):
    model_cfg = _model_cfg(flash, num_classes)
    batches = _batches(num_classes, seed=num_classes)
    wm = _pool(JaxWorkerManager)
    JaxAllocator(model_cfg, wm, None, None).even_allocate()
    jps = JaxParameterServer(model_cfg, example_inputs=batches[0][0],
                             rng=jax.random.key(0))
    jmodel = JaxPipelineModel(wm, jps, optax.sgd(1e-2),
                              jlosses.cross_entropy_loss, devices=devices)
    jrunner = JaxRunner(jmodel, jps, wm, max_epochs=0, max_iters=0)
    ref = jrunner.evaluate(batches, task=task)
    ref_two = jrunner.evaluate(batches, max_batches=2)

    model, ps, pwm = _port_world(model_cfg,
                                 params_from_jax(jps.params, model_cfg))
    runner = Runner(model, ps, pwm, max_epochs=0, max_iters=0)
    got = runner.evaluate(batches, task=task)
    assert got["num_examples"] == ref["num_examples"] == 21
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert sorted(got) == sorted(ref)
    for key in got:
        if key != "loss":
            assert got[key] == pytest.approx(ref[key], abs=0, nan_ok=True), \
                key
    two = runner.evaluate(batches, max_batches=2)
    assert two["num_examples"] == ref_two["num_examples"] == 16
    np.testing.assert_allclose(two["loss"], ref_two["loss"], rtol=1e-5)
    assert two["accuracy"] == ref_two["accuracy"]
    assert model._train  # train mode restored


def test_evaluate_weights_ragged_batches_per_example():
    model, ps, wm = _port_world(_model_cfg(True))
    (data, labels), = _batches(3, sizes=(8,), seed=5)
    small = (tuple(x[:2] for x in data), labels[:2])
    runner = Runner(model, ps, wm, max_epochs=0, max_iters=0)
    metrics = runner.evaluate([(data, labels), small])
    model.train(False)
    big_loss = float(tlosses.cross_entropy_loss(
        model.forward(data), torch.from_numpy(labels)))
    small_loss = float(tlosses.cross_entropy_loss(
        model.forward(small[0]), torch.from_numpy(small[1])))
    model.train(True)
    assert metrics["num_examples"] == 10
    assert metrics["loss"] == pytest.approx(
        (big_loss * 8 + small_loss * 2) / 10, rel=1e-6)
    # identical rows in a ragged split score as one full batch does
    same = runner.evaluate([(tuple(x[:n] for x in data), labels[:n])
                            for n in (8, 8, 4)])
    assert same["num_examples"] == 20
    assert same["loss"] == pytest.approx(
        (big_loss * 16 + runner.evaluate(
            [(tuple(x[:4] for x in data), labels[:4])])["loss"] * 4) / 20,
        rel=1e-6)


class _TokenModel:
    """A stand-in pipeline whose forward returns fixed token logits."""

    def __init__(self, logits, loss_fn, to_array):
        self._logits = logits
        self._loss_fn = loss_fn
        self._to_array = to_array
        self._next = 0
        self.stats = None

    def train(self, mode=True):
        pass

    def forward(self, data):
        out = self._to_array(self._logits[self._next])
        self._next += 1
        return out


def test_token_logits_score_the_next_token_as_jax(devices):
    rng = np.random.default_rng(7)
    logits = [rng.normal(size=(n, 6, 11)).astype(np.float32)
              for n in (4, 3)]
    batches = [((None,), rng.integers(0, 11, size=(n, 6)).astype(np.int32))
               for n in (4, 3)]
    port = Runner(_TokenModel(logits, tlosses.causal_lm_loss,
                              torch.from_numpy), None,
                  SimpleNamespace(size=1), max_epochs=0, max_iters=0)
    ref = JaxRunner(_TokenModel(logits, jlosses.causal_lm_loss,
                                jnp.asarray), None,
                    SimpleNamespace(size=1), max_epochs=0, max_iters=0)
    got, want = port.evaluate(batches), ref.evaluate(batches)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == want["accuracy"]
    assert got["num_examples"] == want["num_examples"] == 7
    port.model._next = 0
    with pytest.raises(ValueError, match="token-level logits"):
        port.evaluate(batches, task="mnli")
    with pytest.raises(ValueError, match="unknown task"):
        port.evaluate(batches, task="squad")


# --- hooks -----------------------------------------------------------------

def _train_world(seed=0):
    model, ps, wm = _port_world(_model_cfg(True), seed=seed)
    loader = BatchAdapter(DataLoader(
        RandomBertDataset(num_samples=64, max_seq_length=SEQ,
                          vocab_size=1024, seed=seed),
        batch_size=8, shuffle=False))
    return model, ps, wm, loader


def test_eval_and_metrics_hooks(tmp_path):
    model, ps, wm, loader = _train_world()
    runner = Runner(model, ps, wm, max_epochs=2, max_iters=16)
    path = tmp_path / "metrics.jsonl"
    metrics_hook = MetricsHook(str(path), flush_every=3)
    lines_seen = []

    class Probe(Hook):
        def after_iter(self, r):
            lines_seen.append(len(path.read_text().splitlines()))

    runner.register_hook(EvalHook(loader, interval=1, max_batches=2))
    runner.register_hook(metrics_hook)
    runner.register_hook(Probe())
    runner.train(loader)

    assert len(runner.eval_history) == 2  # one per epoch
    for epoch, metrics in enumerate(runner.eval_history, start=1):
        assert metrics["epoch"] == epoch and metrics["num_examples"] == 16
        assert 0.0 <= metrics["accuracy"] <= 1.0
        assert np.isfinite(metrics["loss"])
    # the header at once, then every third iteration record
    assert lines_seen == [1 + 3 * (i // 3) for i in range(1, 17)]
    records = [json.loads(line) for line in path.read_text().splitlines()]
    header, rows = records[0], records[1:]
    assert header["event"] == "run_start" and header["world_size"] == 3
    assert (header["epoch"], header["iter"]) == (0, 0)
    assert len(rows) == 16  # train iterations only, none from eval
    assert [r["iter"] for r in rows] == list(range(1, 17))
    assert all(r["run_id"] == header["run_id"] for r in rows)
    assert all(sorted(model.stats.snapshot()) == sorted(
        k for k in r if k not in ("ts", "run_id", "epoch", "iter"))
        for r in rows)
    jax_hash = JaxMetricsHook._config_hash(SimpleNamespace(
        model=SimpleNamespace(partition_signature=lambda: [3, 3, 3]),
        max_epochs=2, max_iters=16))
    assert header["config_hash"] == jax_hash
    # a second run appends under a new run id
    runner2 = Runner(model, ps, wm, max_epochs=1, max_iters=2)
    runner2.register_hook(MetricsHook(str(path)))
    runner2.train(loader)
    again = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(again) == 17 + 3 and again[17]["event"] == "run_start"
    assert again[17]["run_id"] != header["run_id"]


def test_hooks_build_from_the_registry(tmp_path):
    assert isinstance(build_hook(dict(type="NanGuardHook", action="raise")),
                      NanGuardHook)
    assert isinstance(build_hook(dict(type="WatchdogHook",
                                      max_iter_seconds=1.0)), WatchdogHook)
    assert isinstance(build_hook(dict(type="MetricsHook",
                                      path=str(tmp_path / "m.jsonl"))),
                      MetricsHook)
    assert isinstance(build_hook(dict(type="EvalHook", data_loader=[])),
                      EvalHook)


def test_nan_guard_stops_run():
    model, ps, wm, loader = _train_world()
    runner = Runner(model, ps, wm, max_epochs=10, max_iters=100)
    runner.register_hook(NanGuardHook(action="stop"))
    real_step = model.train_step

    def poisoned_step(data, labels, generator=None):
        real_step(data, labels, generator=generator)
        if runner.iter >= 2:
            model.stats.loss = float("nan")
        return model.stats.loss

    model.train_step = poisoned_step
    runner.train(loader)
    assert runner.iter == 3  # iteration 2 went NaN; stopped right after


def test_nan_guard_raise_action():
    model, ps, wm, loader = _train_world()
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=5)
    runner.register_hook(NanGuardHook(action="raise"))
    real_step = model.train_step

    def poisoned_step(data, labels, generator=None):
        real_step(data, labels, generator=generator)
        model.stats.loss = float("inf")
        return model.stats.loss

    model.train_step = poisoned_step
    with pytest.raises(FloatingPointError, match="non-finite"):
        runner.train(loader)
    assert runner.aborted and runner.iter == 1


def test_watchdog_flags_slow_iterations(monkeypatch):
    model, ps, wm, loader = _train_world()
    runner = Runner(model, ps, wm, max_epochs=10, max_iters=50)
    runner.register_hook(
        WatchdogHook(max_iter_seconds=0.05, action="stop", grace_iters=2))
    # the hook's clock, advanced by each step: 0.01 s, then 0.2 s from
    # iteration 2 on
    now = [0.0]
    monkeypatch.setattr(watchdog_hook, "time",
                        SimpleNamespace(perf_counter=lambda: now[0]))
    real_step = model.train_step

    def slow_step(data, labels, generator=None):
        out = real_step(data, labels, generator=generator)
        now[0] += 0.2 if runner.iter >= 2 else 0.01
        return out

    model.train_step = slow_step
    runner.train(loader)
    assert runner.iter == 3  # iteration 2 overran; the grace covers 0, 1


def test_bad_actions_rejected():
    with pytest.raises(ValueError):
        NanGuardHook(action="explode")
    with pytest.raises(ValueError):
        WatchdogHook(1.0, action="panic")


# --- ops/metrics.py --------------------------------------------------------

@pytest.mark.parametrize("seed,n,classes", [
    (0, 50, 2), (1, 37, 3), (2, 5, 2), (3, 0, 2)])
def test_metrics_match_jax(seed, n, classes):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, classes, size=(n,))
    labels = rng.integers(0, classes, size=(n,))
    for name in ("accuracy", "f1_score", "matthews_corrcoef"):
        got = getattr(tmetrics, name)(preds, labels)
        want = getattr(jmetrics, name)(preds, labels)
        assert got == pytest.approx(want, abs=0, nan_ok=True), name
    assert sorted(tmetrics.TASK_METRICS) == sorted(jmetrics.TASK_METRICS)
    for task in list(jmetrics.TASK_METRICS) + ["unknown"]:
        got = tmetrics.compute_task_metrics(task, preds, labels)
        want = jmetrics.compute_task_metrics(task, preds, labels)
        assert got == pytest.approx(want, abs=0, nan_ok=True), task
    # constant predictions: Matthews is 0, F1 has no positives to score
    zeros = np.zeros(4, int)
    assert tmetrics.matthews_corrcoef(zeros, zeros) == 0.0
    assert np.isnan(tmetrics.f1_score(zeros, zeros))
