"""Pipeline trainer port contracts on the CPU: the port's
``PipelineModel`` (tiny BERT, 2 encoder units, 3 workers, GPipe with 2
microbatches) against the JAX package's on the same weights and numpy
batch — forward, two ``train_step``s' losses and updated parameters at
rtol 1e-4 / atol 1e-6 — plus microbatched against full-batch gradients,
the rematerialized dropout mask, ``Runner.train``, the parameter
server's checkpoint round trip and initializer, even allocation,
losses, data generators, and what slice 3 leaves unported."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.dataset import DataLoader as JaxDataLoader
from skycomputing_tpu.dataset import RandomTokenGenerator as JaxTokens
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu_torch import build_layer_stack, params_from_jax
from skycomputing_tpu_torch.dataset import DataLoader, RandomTokenGenerator
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops import build_loss, losses as tlosses
from skycomputing_tpu_torch.parallel import PipelineModel, StageRuntime, sgd
from skycomputing_tpu_torch.runner import Hook, Runner

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
CPU = [torch.device("cpu")]


def _model_cfg(dropout=0.0, flash=True):
    cfg = bert_config("tiny", dtype="float32", hidden_dropout_prob=dropout,
                      attention_probs_dropout_prob=dropout,
                      use_flash_attention=flash)
    return bert_layer_configs(cfg, num_encoder_units=2, num_classes=3,
                              deterministic=(dropout == 0.0))


def _pool(manager_cls, n_workers):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n_workers)
    ])
    return wm


def _batch(seed=0, batch=8, seq=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, size=(batch, seq)).astype(np.int32)
    types = np.zeros_like(ids)
    mask = np.ones_like(ids)
    mask[-1, seq - 5:] = 0  # one padded row
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    return (ids, types, mask), labels


def _port(model_cfg, state_dicts=None, n_workers=3, micro=2, seed=0):
    wm = _pool(WorkerManager, n_workers)
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(seed))
    model = PipelineModel(wm, ps, sgd(LR), tlosses.cross_entropy_loss,
                          devices=CPU, num_microbatches=micro)
    return model, ps, wm


@pytest.fixture(scope="module")
def jax_run(devices):
    """The JAX pipeline's forward, two steps' losses and the updated
    weights, with its initial weights and the batch."""
    model_cfg = _model_cfg()
    data, labels = _batch()
    wm = _pool(JaxWorkerManager, 3)
    JaxAllocator(model_cfg, wm, None, None).even_allocate()
    ps = JaxParameterServer(model_cfg, example_inputs=data,
                            rng=jax.random.key(0))
    init = params_from_jax(ps.params, model_cfg)
    model = JaxPipelineModel(wm, ps, optax.sgd(LR),
                             jlosses.cross_entropy_loss, devices=devices,
                             num_microbatches=2)
    logits = np.asarray(model.forward(data))
    losses = [model.train_step(data, labels, rng=jax.random.key(i))
              for i in range(2)]
    model.sync_to_parameter_server()
    return dict(model_cfg=model_cfg, data=data, labels=labels, init=init,
                logits=logits, losses=losses,
                trained=params_from_jax(ps.params, model_cfg),
                partition=[len(w.model_config) for w in wm.worker_pool])


def test_even_allocation_matches_jax(jax_run):
    model, _, wm = _port(jax_run["model_cfg"], jax_run["init"])
    assert [len(w.model_config) for w in wm.worker_pool] == \
        jax_run["partition"] == [3, 3, 3]
    assert [w.order for w in wm.worker_pool] == [1, 2, 3]
    assert model.partition_signature() == jax_run["partition"]


def test_forward_matches_jax_and_the_monolithic_stack(jax_run):
    model, ps, _ = _port(jax_run["model_cfg"], jax_run["init"])
    logits = model.forward(jax_run["data"])
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"],
                               rtol=1e-4, atol=1e-5)
    stack = build_layer_stack(jax_run["model_cfg"])
    for module, sd in zip(stack.layers, ps.params):
        module.load_state_dict(sd)
    ref = stack(*(torch.from_numpy(a) for a in jax_run["data"]))
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-6)


def test_two_train_steps_match_jax(jax_run):
    model, ps, _ = _port(jax_run["model_cfg"], jax_run["init"])
    losses = [model.train_step(jax_run["data"], jax_run["labels"])
              for _ in range(2)]
    np.testing.assert_allclose(losses, jax_run["losses"], **TOL)
    assert model.stats.forward_s > 0 and model.stats.backward_s > 0
    assert model.stats.loss == losses[-1]
    model.sync_to_parameter_server()
    for got, ref in zip(ps.params, jax_run["trained"]):
        assert sorted(got) == sorted(ref)
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       **TOL, err_msg=key)


def test_microbatched_grads_equal_full_batch_grads(jax_run):
    full, _, _ = _port(jax_run["model_cfg"], jax_run["init"], micro=1)
    micro, _, _ = _port(jax_run["model_cfg"], jax_run["init"], micro=4)
    g_full, l_full, _ = full.compute_gradients(jax_run["data"],
                                               jax_run["labels"])
    g_micro, l_micro, _ = micro.compute_gradients(jax_run["data"],
                                                  jax_run["labels"])
    assert len(l_micro) == 4
    np.testing.assert_allclose(sum(l.item() for l in l_micro),
                               l_full[0].item(), rtol=1e-5)
    for a_stage, b_stage in zip(g_full, g_micro):
        for a, b in zip(a_stage, b_stage):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)


def test_rematerialized_backward_reuses_the_forward_dropout_mask():
    """With live dropout, each stage's backward re-runs its forward under
    the same seed: the pipeline's gradients equal autograd through the
    stages run once, each under its seed."""
    model_cfg = _model_cfg(dropout=0.2, flash=False)
    data, labels = _batch(3)
    model, _, _ = _port(model_cfg, micro=1, seed=4)
    assert all(stage.stochastic for stage in model.stages)
    grads, losses, _ = model.compute_gradients(
        data, labels, generator=torch.Generator().manual_seed(11))
    seeds = torch.randint(0, 2 ** 62, (1, len(model.stages)),
                          generator=torch.Generator().manual_seed(11))
    acts = tuple(torch.from_numpy(a) for a in data)
    for stage in model.stages:
        stage.optimizer.zero_grad(set_to_none=True)
    for stage, seed in zip(model.stages, seeds[0].tolist()):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            out = stage.stack(*acts)
        acts = out if isinstance(out, tuple) else (out,)
    loss = tlosses.cross_entropy_loss(acts[0], torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(losses[0].item(), loss.item(), rtol=1e-6)
    for stage, stage_grads in zip(model.stages, grads):
        for p, g in zip(stage.parameters, stage_grads):
            torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-7)


def test_runner_stops_at_max_iters():
    model_cfg = _model_cfg()
    model, ps, wm = _port(model_cfg)
    data, labels = _batch(1)

    class Count(Hook):
        def __init__(self):
            self.iters = self.epochs = self.runs = 0

        def after_train_iter(self, runner):
            self.iters += 1

        def after_train_epoch(self, runner):
            self.epochs += 1

        def after_run(self, runner):
            self.runs += 1

    runner = Runner(model, ps, wm, max_epochs=2, max_iters=3)
    count = Count()
    runner.register_hook(count)
    runner.train([(data, labels)] * 5)
    assert (runner.iter, runner.epoch, runner.inner_iter) == (3, 0, 3)
    assert (count.iters, count.epochs, count.runs) == (3, 0, 1)
    assert runner.phase_timer.counts["step"] == 3
    with pytest.raises(TypeError):
        runner.register_hook(object())


def test_runner_counts_whole_epochs():
    model, ps, wm = _port(_model_cfg())
    data, labels = _batch(2)
    runner = Runner(model, ps, wm, max_epochs=2, max_iters=10)
    runner.train([(data, labels)] * 2)
    assert (runner.iter, runner.epoch) == (4, 2)


def test_parameter_server_checkpoint_round_trip(tmp_path):
    model_cfg = _model_cfg()
    ps = ParameterServer(model_cfg, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "ckpt.pt")
    ps.save_weights_to_file(path)
    other = ParameterServer(model_cfg, generator=torch.Generator()
                            .manual_seed(4))
    other.load_weights_from_file(path)
    for a, b in zip(ps.params, other.params):
        assert sorted(a) == sorted(b)
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        other.load_weights_from_file(str(tmp_path / "missing.pt"))
    (tmp_path / "torn.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="corrupt"):
        other.load_weights_from_file(str(tmp_path / "torn.pt"))


def test_parameter_server_initializer_follows_flax():
    """Seeded draws with flax's distributions: N(0, 0.02) embeddings and
    encoder kernels, lecun-normal classifier, zero biases, unit
    LayerNorm scales; the same seed gives the same weights."""
    model_cfg = _model_cfg()
    ps = ParameterServer(model_cfg, generator=torch.Generator().manual_seed(0))
    again = ParameterServer(model_cfg,
                            generator=torch.Generator().manual_seed(0))
    emb, head, classifier = ps.params[0], ps.params[1], ps.params[-1]
    assert abs(emb["word_embeddings.weight"].std().item() - 0.02) < 1e-3
    assert abs(head["self.query.weight"].std().item() - 0.02) < 2e-3
    assert (head["self.query.bias"] == 0).all()
    assert (head["output.LayerNorm.weight"] == 1).all()
    w = classifier["classifier.weight"]  # [3, 128], fan_in 128
    assert w.abs().max().item() <= 2 * 128 ** -0.5 / 0.8796 + 1e-6
    assert abs(w.std().item() - 128 ** -0.5) < 0.02
    for a, b in zip(ps.params, again.params):
        for key in a:
            assert torch.equal(a[key], b[key])


def test_rebuild_after_reallocation_keeps_the_weights():
    model_cfg = _model_cfg()
    model, ps, wm = _port(model_cfg)
    data, labels = _batch(4)
    model.train_step(data, labels)
    before = model.forward(data)
    start = 0
    for worker, take in zip(wm.worker_pool, (5, 2, 2)):
        worker.model_config = model_cfg[start:start + take]
        start += take
    model.rebuild()
    assert model.partition_signature() == [5, 2, 2]
    torch.testing.assert_close(model.forward(data), before, rtol=1e-6,
                               atol=1e-6)
    model.load_from_parameter_server()
    torch.testing.assert_close(model.forward(data), before, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["cross_entropy", "mse", "causal_lm",
                                  "causal_lm_masked"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(7)
    if kind == "cross_entropy":
        logits = rng.standard_normal((6, 5)).astype(np.float32)
        labels = rng.integers(0, 5, 6).astype(np.int32)
        args, kw = (logits, labels), {}
        name = "cross_entropy_loss"
    elif kind == "mse":
        args, kw = (rng.standard_normal((4, 3)).astype(np.float32),
                    rng.standard_normal((4, 3)).astype(np.float32)), {}
        name = "mse_loss"
    else:
        logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
        labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
        mask = np.ones((2, 7), np.int32)
        mask[1, 4:] = 0
        args = (logits, labels)
        kw = dict(mask=mask, pad_id=3) if kind.endswith("masked") else {}
        name = "causal_lm_loss"
    ref = getattr(jlosses, name)(*map(jnp.asarray, args),
                                 **{k: (jnp.asarray(v) if k == "mask" else v)
                                    for k, v in kw.items()})
    got = getattr(tlosses, name)(*map(torch.from_numpy, args),
                                 **{k: (torch.from_numpy(v) if k == "mask"
                                        else v) for k, v in kw.items()})
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_build_loss_config():
    fn = build_loss({"type": "CausalLmLoss", "pad_id": 0})
    assert fn.keywords == {"pad_id": 0}
    with pytest.raises(ValueError, match="unknown options"):
        build_loss({"type": "CrossEntropyLoss", "pad_id": 0})
    with pytest.raises(ValueError, match="shadow"):
        build_loss({"type": "CausalLmLoss", "labels": 0})


def test_slowdown_emulation_sleeps_elapsed_times_factor_minus_one(
        monkeypatch):
    """A worker's ``slowdown`` makes its stage sleep ``elapsed x
    (slowdown - 1)`` after each call (heterogeneity emulation), through
    the injectable clock and sleep."""
    model_cfg = _model_cfg()
    wm = _pool(WorkerManager, 3)
    wm.worker_pool[1].extra_config["slowdown"] = 3.0
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg)
    model = PipelineModel(wm, ps, sgd(LR), tlosses.cross_entropy_loss,
                          devices=CPU)
    ticks, slept = iter(range(1000)), []
    monkeypatch.setattr(StageRuntime, "_clock",
                        staticmethod(lambda: float(next(ticks))))
    monkeypatch.setattr(StageRuntime, "_sleep", staticmethod(slept.append))
    data, labels = _batch(5)
    model.train_step(data, labels)
    # stage 1 only: its forward and its backward, each 1 fake second
    assert [s.slowdown for s in model.stages] == [1.0, 3.0, 1.0]
    assert slept == [2.0, 2.0]


def test_data_generators_and_loader_match_jax():
    for a, b in zip(RandomTokenGenerator(4, 8, 100, seed=3).generate(),
                    JaxTokens(4, 8, 100, seed=3).generate()):
        np.testing.assert_array_equal(a, b)

    class Rows:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return (np.full(3, i), np.int32(i)), i % 2

    for shuffle in (False, True):
        port = list(DataLoader(Rows(), batch_size=2, shuffle=shuffle,
                               seed=5))
        ref = list(JaxDataLoader(Rows(), batch_size=2, shuffle=shuffle,
                                 seed=5))
        assert len(port) == len(ref) == 3
        for (pd, pl), (rd, rl) in zip(port, ref):
            np.testing.assert_array_equal(pl, rl)
            for x, y in zip(pd, rd):
                np.testing.assert_array_equal(x, y)


def test_what_slice_3_leaves_unported_raises():
    """What slice 3 left is ported now (1F1B, ``measure_stage_times``,
    the profile-driven allocations: ``tests/test_torch_schedule.py`` and
    ``tests/test_torch_dynamics.py``; the serving allocation:
    ``tests/test_torch_serving_alloc.py``), and so is the runner's
    live-metrics exporter (``tests/test_torch_exporter.py``)."""
    model_cfg = _model_cfg()
    model, ps, wm = _port(model_cfg)
    PipelineModel(wm, ps, sgd(LR), tlosses.cross_entropy_loss,
                  devices=CPU, schedule="1f1b")
    with pytest.raises(ValueError, match="unknown schedule"):
        PipelineModel(wm, ps, sgd(LR), tlosses.cross_entropy_loss,
                      devices=CPU, schedule="zigzag")
    assert len(model.measure_stage_times(_batch()[0], repeats=1,
                                         inner_iters=1)) == 3
    # pre-flight is ported (tests/test_torch_plan_check.py) and on by
    # default; the live-metrics exporter serves the runner's registry
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=1)
    runner.train([_batch()])
    assert [r.ok for r in runner.preflight_reports] == [True]
    exporter = runner.start_exporter()
    try:
        assert exporter.port > 0 and runner.start_exporter() is exporter
    finally:
        runner.stop_exporter()
    assert runner._exporter is None
