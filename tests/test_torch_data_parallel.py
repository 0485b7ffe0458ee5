"""Data-parallel replicas of the pipeline in the port
(``parallel/data_parallel.py``): the five contracts of
``tests/test_data_parallel.py`` (the averaged update equals one
pipeline on the whole batch; replicas stay identical over steps; a
checkpoint resumes through ``CheckpointHook`` into every replica; 1F1B
computes GPipe's step; too few devices are refused), the per-replica
dropout masks, and two SGD steps against JAX's
``DataParallelPipeline`` on the same weights and batch under GPipe and
1F1B: losses within 1e-5 relative, parameters within 1e-5.  Tiny BERT,
2 encoder units, 4 workers, 2 replicas; the port's replicas on CPU
positions, JAX's on its 8 CPU devices."""

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu.ops import cross_entropy_loss as jax_ce
from skycomputing_tpu.parallel import (
    DataParallelPipeline as JaxDataParallelPipeline,
)
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.ops.losses import cross_entropy_loss
from skycomputing_tpu_torch.parallel import (
    DataParallelPipeline,
    PipelineModel,
    build_optimizer,
    sgd,
)
from skycomputing_tpu_torch.runner import CheckpointHook, Runner

pytestmark = pytest.mark.torch_port

CPUS = [torch.device("cpu")] * 8
LR = 1e-2


def _units(pkg_config, pkg_layers, dropout=0.0):
    cfg = pkg_config("tiny", dtype="float32", hidden_dropout_prob=dropout,
                     attention_probs_dropout_prob=0.0)
    return pkg_layers(cfg, num_encoder_units=2, num_classes=3,
                      deterministic=dropout == 0.0)


def _pool(manager_cls, n=4):
    wm = manager_cls()
    wm.load_worker_pool_from_config(
        [dict(name=f"n{i}", device_config=dict(device_index=i),
              extra_config={}) for i in range(n)])
    return wm


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, size=(8, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[-1, 11:] = 0
    labels = rng.integers(0, 3, size=(8,)).astype(np.int32)
    return (ids, np.zeros_like(ids), mask), labels


def build(seed=0, dropout=0.0, state_dicts=None):
    units = _units(bert_config, bert_layer_configs, dropout)
    wm = _pool(WorkerManager)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(seed))
    data, labels = _batch(seed)
    return wm, ps, data, labels


def _stage_params(model):
    return [p for stage in model.stages for p in stage.parameters]


def _replicas_equal(dp):
    return all(torch.equal(a, b) for a, b in zip(
        _stage_params(dp.replicas[0]), _stage_params(dp.replicas[1])))


def test_dp_update_equals_full_batch():
    """R=2 averaged-gradient update == one pipeline on the whole batch
    (deterministic model, the loss a per-example mean)."""
    wm, ps, data, labels = build()
    dp = DataParallelPipeline(wm, ps, sgd(LR), cross_entropy_loss,
                              num_replicas=2, devices=CPUS)
    single = PipelineModel(wm, ps, sgd(LR), cross_entropy_loss,
                           devices=CPUS[:4])
    loss_dp = dp.train_step(data, labels)
    loss_single = single.train_step(data, labels)
    assert loss_dp == pytest.approx(loss_single, rel=1e-5)
    for a, b in zip(_stage_params(dp.replicas[0]), _stage_params(single)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert dp.stats.interleaved and dp.stats.loss == loss_dp
    assert dp.stats.forward_s > 0 and dp.stats.step_s > 0


def test_replicas_stay_identical_over_steps():
    wm, ps, data, labels = build(seed=1)
    dp = DataParallelPipeline(
        wm, ps, build_optimizer(dict(optim_type="adam", learning_rate=1e-3)),
        cross_entropy_loss, num_replicas=2, devices=CPUS)
    losses = [dp.train_step(data, labels,
                            generator=torch.Generator().manual_seed(i))
              for i in range(4)]
    assert losses[-1] < losses[0]
    # the replicas' stages lie on their own slices of the device list
    assert [s.stage_index for s in dp.replicas[1].stages] == [0, 1, 2, 3]
    assert _replicas_equal(dp)


def test_dropout_masks_differ_per_replica_and_replicas_stay_identical():
    """With dropout each replica draws its own masks (a batch whose two
    halves are equal gives the replicas different losses), and the
    shared averaged update still keeps them identical."""
    wm, ps, data, labels = build(seed=2, dropout=0.1)
    half = tuple(np.concatenate([x[:4], x[:4]]) for x in data)
    half_labels = np.concatenate([labels[:4], labels[:4]])
    dp = DataParallelPipeline(wm, ps, sgd(LR), cross_entropy_loss,
                              num_replicas=2, devices=CPUS)
    per_replica = []
    for model in dp.replicas:
        compute = model.compute_gradients

        def spy(*args, _compute=compute, **kwargs):
            out = _compute(*args, **kwargs)
            per_replica.append(float(sum(out[1])))
            return out

        model.compute_gradients = spy
    for step in range(2):
        dp.train_step(half, half_labels,
                      generator=torch.Generator().manual_seed(step))
        assert _replicas_equal(dp)
    assert per_replica[0] != per_replica[1]
    assert per_replica[2] != per_replica[3]


def test_dp_checkpoint_resume_through_hook(tmp_path):
    """Save and restore a data-parallel run through CheckpointHook, the
    optimizer state included: every replica restored, identical."""
    wm, ps, data, labels = build(seed=4)
    adam = build_optimizer(dict(optim_type="adam", learning_rate=1e-3))
    dp = DataParallelPipeline(wm, ps, adam, cross_entropy_loss,
                              num_replicas=2, devices=CPUS)
    loader = [(data, labels)] * 2
    save_dir = str(tmp_path / "dpck")
    r1 = Runner(dp, ps, wm, max_epochs=1, max_iters=100, seed=2)
    hook = CheckpointHook(save_path=save_dir, save_interval=1,
                          save_training_state=True)
    r1.register_hook(hook)
    r1.train(loader)
    ckpt = hook.last_saved
    assert ckpt.endswith("epoch_1.pt")
    assert [r.ok for r in r1.preflight_reports] == [True]

    wm2, ps2, *_ = build(seed=5)
    dp2 = DataParallelPipeline(wm2, ps2, adam, cross_entropy_loss,
                               num_replicas=2, devices=CPUS)
    r2 = Runner(dp2, ps2, wm2, max_epochs=2, max_iters=100, seed=2)
    r2.register_hook(CheckpointHook(load_checkpoint_from=ckpt))
    r2.train(loader)
    assert r2.epoch == 2  # resumed from epoch 1, ran one more
    assert _replicas_equal(dp2)
    state = [s.optimizer.state_dict()["state"] for s in dp2.replicas[1].stages]
    assert all(int(v["step"]) == 4 for st in state for v in st.values())


def test_dp_1f1b_schedule_matches_gpipe():
    """schedule='1f1b' reaches the replicas and computes GPipe's step."""
    wm, ps, data, labels = build(seed=7)
    dp_1f1b = DataParallelPipeline(
        wm, ps, sgd(LR), cross_entropy_loss, num_replicas=2, devices=CPUS,
        num_microbatches=2, schedule="1f1b")
    assert all(m.schedule == "1f1b" for m in dp_1f1b.replicas)
    wm2, ps2, *_ = build(seed=7)
    dp_gpipe = DataParallelPipeline(
        wm2, ps2, sgd(LR), cross_entropy_loss, num_replicas=2,
        devices=CPUS, num_microbatches=2, schedule="gpipe")
    assert dp_1f1b.train_step(data, labels) == pytest.approx(
        dp_gpipe.train_step(data, labels), rel=1e-5)
    for a, b in zip(_stage_params(dp_1f1b.replicas[0]),
                    _stage_params(dp_gpipe.replicas[0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_too_few_devices_rejected():
    wm, ps, *_ = build()
    with pytest.raises(ValueError, match="need 12 devices, have 8"):
        DataParallelPipeline(wm, ps, sgd(LR), cross_entropy_loss,
                             num_replicas=3, devices=CPUS)
    dp = DataParallelPipeline(wm, ps, sgd(LR), cross_entropy_loss,
                              num_replicas=2, devices=CPUS)
    with pytest.raises(ValueError, match="not divisible by 2 replicas"):
        dp.train_step(tuple(x[:7] for x in _batch(0)[0]), _batch(0)[1][:7])


@pytest.fixture(scope="module")
def jax_dp(devices):
    """JAX's data-parallel pipeline, two SGD steps under each schedule,
    from one set of initial weights."""
    units = _units(jax_bert_config, jax_bert_layers)
    data, labels = _batch(9)
    out = {}
    for schedule in ("gpipe", "1f1b"):
        wm = _pool(JaxWorkerManager)
        JaxAllocator(units, wm, None, None).even_allocate()
        ps = JaxParameterServer(units, example_inputs=data,
                                rng=jax.random.key(3))
        init = params_from_jax(ps.params, units)
        model = JaxDataParallelPipeline(
            wm, ps, optax.sgd(LR), jax_ce, num_replicas=2, devices=devices,
            num_microbatches=2, schedule=schedule)
        losses = [model.train_step(data, labels, rng=jax.random.key(i))
                  for i in range(2)]
        model.sync_to_parameter_server()
        out[schedule] = dict(init=init, losses=losses,
                             trained=params_from_jax(ps.params, units))
    return dict(units=units, data=data, labels=labels, runs=out)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_two_sgd_steps_match_jax(jax_dp, schedule):
    run = jax_dp["runs"][schedule]
    assert _units(bert_config, bert_layer_configs) == jax_dp["units"]
    wm, ps, *_ = build(state_dicts=run["init"])
    dp = DataParallelPipeline(wm, ps, sgd(LR), cross_entropy_loss,
                              num_replicas=2, devices=CPUS,
                              num_microbatches=2, schedule=schedule)
    losses = [dp.train_step(jax_dp["data"], jax_dp["labels"])
              for _ in range(2)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    dp.sync_to_parameter_server()
    for got, ref in zip(ps.params, run["trained"]):
        assert sorted(got) == sorted(ref)
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    assert _replicas_equal(dp)


def test_preflight_verifies_one_replicas_shard():
    """The pre-flight unwraps the replicas and checks one replica's
    shard of the batch: a batch the replicas cannot split is refused
    before any step, as in JAX."""
    from skycomputing_tpu_torch.analysis import has_plan, verify_pipeline

    wm, ps, data, _ = build()
    dp = DataParallelPipeline(wm, ps, sgd(LR), cross_entropy_loss,
                              num_replicas=2, devices=CPUS)
    assert has_plan(dp)
    assert verify_pipeline(dp, data).ok
    report = verify_pipeline(dp, tuple(x[:7] for x in data))
    assert not report.ok
    assert report.errors[0].message == (
        "batch axis 7 is not divisible by the wrapper's 2 replicas — "
        "_split_replicas will reject this batch at the first step")
