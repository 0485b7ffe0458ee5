"""Schedule, stage-timing, optimizer and hook port contracts on the CPU
(tiny BERT, 2 encoder units, 3 workers): the 1F1B schedule against the
JAX engine's 1F1B (losses and updated weights after two steps, same
weights and batch) and against the port's GPipe; ``measure_stage_times``
(one positive time per stage, identical stages timed once, slowdown
applied on top of raw cached times); the partition-tagged optimizer
state; ``build_optimizer`` against optax's sgd, adam and adamw on equal
gradients and through the whole pipeline; and the stop, timer and checkpoint hooks, a
checkpoint restoring under another allocation."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops import losses as tlosses
from skycomputing_tpu_torch.parallel import (
    PipelineModel,
    build_optimizer,
    sgd,
)
from skycomputing_tpu_torch.runner import (
    CheckpointHook,
    DistributedTimerHelperHook,
    Hook,
    Runner,
    StopHook,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
LR = 1e-2
CPU = [torch.device("cpu")]


def _model_cfg(units=2):
    cfg = bert_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    return bert_layer_configs(cfg, num_encoder_units=units, num_classes=3,
                              deterministic=True)


def _pool(manager_cls, n):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n)
    ])
    return wm


def _batch(seed=0, batch=8, seq=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, size=(batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[-1, seq - 5:] = 0  # one padded row
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    return (ids, np.zeros_like(ids), mask), labels


def _port(model_cfg, state_dicts=None, n_workers=3, micro=4,
          schedule="1f1b", optimizer=None):
    wm = _pool(WorkerManager, n_workers)
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(0))
    model = PipelineModel(wm, ps, optimizer or sgd(LR),
                          tlosses.cross_entropy_loss, devices=CPU,
                          num_microbatches=micro, schedule=schedule)
    return model, ps, wm


def _jax_train(devices, model_cfg, optimizer, schedule, steps=2):
    data, labels = _batch()
    wm = _pool(JaxWorkerManager, 3)
    JaxAllocator(model_cfg, wm, None, None).even_allocate()
    ps = JaxParameterServer(model_cfg, example_inputs=data,
                            rng=jax.random.key(0))
    init = params_from_jax(ps.params, model_cfg)
    model = JaxPipelineModel(wm, ps, optimizer, jlosses.cross_entropy_loss,
                             devices=devices, num_microbatches=4,
                             schedule=schedule)
    losses = [model.train_step(data, labels, rng=jax.random.key(i))
              for i in range(steps)]
    model.sync_to_parameter_server()
    return init, losses, params_from_jax(ps.params, model_cfg)


def _assert_params_close(got_ps, ref):
    for got, want in zip(got_ps.params, ref):
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=key)


@pytest.fixture(scope="module")
def jax_1f1b(devices):
    model_cfg = _model_cfg()
    init, losses, trained = _jax_train(devices, model_cfg, optax.sgd(LR),
                                       "1f1b")
    return dict(model_cfg=model_cfg, init=init, losses=losses,
                trained=trained)


def test_1f1b_matches_jax_1f1b(jax_1f1b):
    model, ps, _ = _port(jax_1f1b["model_cfg"], jax_1f1b["init"])
    data, labels = _batch()
    losses = [model.train_step(data, labels) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_1f1b["losses"], rtol=LOSS_RTOL)
    model.sync_to_parameter_server()
    _assert_params_close(ps, jax_1f1b["trained"])
    # interleaved stats: the loop reads as forward, backward as 0
    assert model.stats.interleaved and model.stats.backward_s == 0.0
    assert model.stats.forward_s > 0 and model.stats.loss == losses[-1]


def test_1f1b_matches_gpipe(jax_1f1b):
    data, labels = _batch(1)
    runs = {}
    for schedule in ("gpipe", "1f1b"):
        model, _, _ = _port(jax_1f1b["model_cfg"], jax_1f1b["init"],
                            schedule=schedule)
        grads, losses, _ = model.compute_gradients(data, labels)
        runs[schedule] = (grads, sorted(l.item() for l in losses))
    np.testing.assert_allclose(runs["1f1b"][1], runs["gpipe"][1], rtol=1e-6)
    for g_stage, f_stage in zip(runs["gpipe"][0], runs["1f1b"][0]):
        for a, b in zip(g_stage, f_stage):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_1f1b_with_one_microbatch_is_not_interleaved():
    model, _, _ = _port(_model_cfg(), micro=1)
    data, labels = _batch(2)
    model.train_step(data, labels)
    assert not model.stats.interleaved and model.stats.backward_s > 0


def test_1f1b_frees_each_stored_input_at_its_backward(monkeypatch):
    """Live stored inputs per stage never exceed the pipeline depth."""
    model, _, _ = _port(_model_cfg(), micro=8)
    live, peak = [0] * 3, [0] * 3
    for k, stage in enumerate(model.stages):
        fwd, bwd = stage.forward, stage.backward

        def f(*a, k=k, fwd=fwd, **kw):
            live[k] += 1
            peak[k] = max(peak[k], live[k])
            return fwd(*a, **kw)

        def b(*a, k=k, bwd=bwd, **kw):
            live[k] -= 1
            return bwd(*a, **kw)

        monkeypatch.setattr(stage, "forward", f)
        monkeypatch.setattr(stage, "backward", b)
    data, labels = _batch(3, batch=16)
    model.train_step(data, labels)
    assert live == [0, 0, 0]
    assert peak == [3, 2, 1]  # S - k in flight, not M = 8


def test_measure_stage_times_times_identical_stages_once(monkeypatch):
    # 1 + 3 x 3 + 2 = 12 layers over 4 stages of 3: the two interior
    # stages are the same (tail, head, body) window
    model, _, wm = _port(_model_cfg(units=3), n_workers=4)
    timed = []
    stage_sampler = PipelineModel._stage_sampler
    monkeypatch.setattr(PipelineModel, "_stage_sampler", staticmethod(
        lambda stage, *a: timed.append(stage.stage_index)
        or stage_sampler(stage, *a)))
    data, _ = _batch()
    times = model.measure_stage_times(data, repeats=1, inner_iters=1)
    assert len(times) == 4 and all(t > 0 for t in times)
    keys = [s.config_key for s in model.stages]
    assert keys[1] == keys[2] and times[1] == times[2]
    assert timed == [0, 1, 3]
    assert len(set(keys)) == 3


def test_measure_stage_times_samples_stages_round_robin(monkeypatch):
    """Each repeat samples every timed stage once, so host drift during
    the pass spreads over all of them; each time is its own median."""
    model, _, _ = _port(_model_cfg(units=3), n_workers=4)
    order = []

    def fake_sampler(stage, *args):
        values = iter([3.0, 1.0, 2.0])
        return lambda: order.append(stage.stage_index) or next(values)

    monkeypatch.setattr(PipelineModel, "_stage_sampler",
                        staticmethod(fake_sampler))
    times = model.measure_stage_times(_batch()[0], repeats=3)
    assert order == [0, 1, 3] * 3
    assert times == [2.0] * 4  # the median of 3, 1, 2; stage 2 reuses 1's


def test_measure_stage_times_applies_slowdown_over_raw_cached_times():
    model, _, _ = _port(_model_cfg())
    data, _ = _batch()
    seen = {}
    raw = model.measure_stage_times(data, repeats=2, inner_iters="auto",
                                    seed_times=seen)
    assert len(seen) == 3 and sorted(seen.values()) == sorted(raw)
    model.stages[1].slowdown = 3.0
    again = model.measure_stage_times(data, seed_times=seen)
    # nothing re-timed: the cached raw times, stage 1 times its slowdown
    assert again == [raw[0], raw[1] * 3.0, raw[2]]
    assert sorted(seen.values()) == sorted(raw)


def test_optimizer_state_rejected_under_another_partition():
    model, _, _ = _port(_model_cfg(),
                        optimizer=build_optimizer(dict(optim_type="adam",
                                                       learning_rate=1e-3)))
    data, labels = _batch()
    model.train_step(data, labels)
    state = model.get_optimizer_state()
    assert state["partition"] == [3, 3, 3]
    other, _, _ = _port(_model_cfg(), n_workers=2)
    with pytest.raises(ValueError, match="partition"):
        other.load_optimizer_state(state)
    same, _, _ = _port(_model_cfg(),
                       optimizer=build_optimizer(dict(optim_type="adam",
                                                      learning_rate=1e-3)))
    same.load_optimizer_state(state)
    for a, b in zip(model.stages, same.stages):
        sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
        for idx in sa["state"]:
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(sb["state"][idx][key],
                                           sa["state"][idx][key])


OPTIMIZERS = [
    ("sgd", {}),
    ("sgd", dict(momentum=0.9, nesterov=True)),
    ("adam", {}),
    ("adamw", {}),
    ("adamw", dict(weight_decay=0.05, b1=0.8)),
]
OPT_IDS = ["sgd", "sgd-nesterov", "adam", "adamw", "adamw-wd"]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS, ids=OPT_IDS)
def test_optimizers_match_optax_on_equal_gradients(name, kwargs):
    """Two updates from the same parameters and gradients: the port's
    ``build_optimizer`` against the optax factory of the same name."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) * s
             for s in (1.0, 1e-3)]
    tx = getattr(optax, name)(1e-2, **kwargs)
    params = jax.numpy.asarray(w0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.numpy.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = build_optimizer(dict(optim_type=name, learning_rate=1e-2,
                               **kwargs))([p])
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    # float32 rounding: the two steps move each weight by up to 2e-2
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,kwargs", [OPTIMIZERS[1], OPTIMIZERS[3]],
                         ids=["sgd-nesterov", "adamw"])
def test_configured_optimizer_trains_like_jax(devices, name, kwargs):
    """Two GPipe steps with the config's optimizer against the JAX
    pipeline with the optax one.  Adam's normalized update amplifies the
    1e-7 gradient differences of near-zero-gradient weights up to the
    learning rate, so for adamw the weights are held by the test above
    and the losses here."""
    model_cfg = _model_cfg()
    lr = 1e-3
    init, losses, trained = _jax_train(
        devices, model_cfg, getattr(optax, name)(lr, **kwargs), "gpipe")
    model, ps, _ = _port(model_cfg, init, schedule="gpipe",
                         optimizer=build_optimizer(
                             dict(optim_type=name, learning_rate=lr,
                                  **kwargs)))
    data, labels = _batch()
    got = [model.train_step(data, labels) for _ in range(2)]
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    if name == "sgd":
        model.sync_to_parameter_server()
        _assert_params_close(ps, trained)


def test_build_optimizer_maps_optax_defaults_and_refuses_the_rest():
    p = [torch.nn.Parameter(torch.zeros(2))]
    adamw = build_optimizer(dict(optim_type="AdamW", learning_rate=0.1))(p)
    assert isinstance(adamw, torch.optim.AdamW)
    assert adamw.defaults["weight_decay"] == 1e-4  # optax's, not torch's
    adam = build_optimizer(dict(optim_type="adam", learning_rate=0.1))(p)
    assert adam.defaults["betas"] == (0.9, 0.999)
    assert adam.defaults["eps"] == 1e-8
    with pytest.raises(ValueError, match="not ported"):
        build_optimizer(dict(optim_type="lamb", learning_rate=0.1))
    with pytest.raises(ValueError, match="eps_root"):
        build_optimizer(dict(optim_type="adam", learning_rate=0.1,
                             eps_root=1e-8))


# ------------------------------------------------------------------ hooks
class _Record(Hook):
    def __init__(self, stop_root=None, stop_at=None):
        self.losses = []
        self._stop_root, self._stop_at = stop_root, stop_at

    def after_train_iter(self, runner):
        self.losses.append(runner.model.stats.loss)
        if self._stop_at is not None and runner.iter == self._stop_at:
            StopHook.stop(self._stop_root)


def test_stop_hook_stops_the_run(tmp_path):
    model, ps, wm = _port(_model_cfg())
    root = str(tmp_path / "stop")
    os.makedirs(root)
    StopHook.stop(root)  # a stale flag from an earlier run
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=10)
    record = _Record(root, stop_at=2)
    for hook in (record, StopHook(root), DistributedTimerHelperHook()):
        runner.register_hook(hook)
    data, labels = _batch()
    runner.train([(data, labels)] * 10)
    assert runner.iter == 2 and len(record.losses) == 2
    assert runner.timer.get_prev_interval() == 0.0  # cleaned after the run


def test_checkpoint_restores_under_another_allocation(tmp_path):
    model_cfg = _model_cfg()
    adam = dict(optim_type="adam", learning_rate=1e-3)
    model, ps, wm = _port(model_cfg, optimizer=build_optimizer(adam))
    save = CheckpointHook(save_path=str(tmp_path), save_interval=1,
                          save_training_state=True)
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=3, seed=4)
    runner.register_hook(save)
    data, labels = _batch()
    runner.train([(data, labels)] * 5)
    path = save.last_saved
    assert path == str(tmp_path / "iter_3.pt")
    assert os.path.exists(CheckpointHook.training_state_path(path))
    model.sync_to_parameter_server()
    trained = [{k: v.clone() for k, v in sd.items()} for sd in ps.params]

    for n_workers, optimizer_restored in ((2, False), (3, True)):
        other, other_ps, other_wm = _port(model_cfg, n_workers=n_workers,
                                          optimizer=build_optimizer(adam))
        assert other.partition_signature() != [3, 3, 3] or optimizer_restored
        resumed = Runner(other, other_ps, other_wm, max_epochs=1,
                         max_iters=3)
        resumed.register_hook(CheckpointHook(load_checkpoint_from=path))
        resumed.train([(data, labels)] * 5)
        assert resumed.iter == 3  # the counters came back: nothing trained
        other.sync_to_parameter_server()
        for got, want in zip(other_ps.params, trained):
            for key in want:
                torch.testing.assert_close(got[key], want[key], rtol=0,
                                           atol=0)
        moments = [s.optimizer.state_dict()["state"] for s in other.stages]
        assert bool(any(moments)) == optimizer_restored
        torch.testing.assert_close(resumed.snapshot_rng(),
                                   runner.snapshot_rng())
