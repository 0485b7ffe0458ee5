"""ResNet and CIFAR-10 in the port against the JAX package
(``skycomputing_tpu/models/resnet.py``, ``dataset/datasets.py``): each
unit of ``resnet_layer_configs("BasicBlock", [1, 1, 1, 1])`` and of a
one-block ``BottleNeck`` stack on the same weights, fed the same input
(the port runs NCHW, JAX NHWC: JAX's activations are transposed to
compare) at rtol and atol 1e-4; the whole stack's logits; ``resnet18``
to ``resnet152``; three SGD steps through ``PipelineModel`` with
falling losses equal to JAX's at rtol 1e-4 / atol 1e-6 (the float32
trainer tolerance of ``tests/test_torch_pipeline.py``); and
``CIFAR10Dataset`` on binary records the test writes and on its
synthetic fallback, array-equal to JAX's."""

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.dataset import CIFAR10Dataset as JaxCifar
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models import resnet as jres
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu_torch import build_layer_stack, params_from_jax
from skycomputing_tpu_torch.builder import build_dataloader_from_cfg
from skycomputing_tpu_torch.dataset import CIFAR10Dataset
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.models import resnet as tres
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import PipelineModel, sgd

pytestmark = pytest.mark.torch_port

UNIT_TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
CPU = [torch.device("cpu")]
STACKS = {"BasicBlock": [1, 1, 1, 1], "BottleNeck": [1, 1, 1, 1]}


def _images(seed, batch=2):
    return np.random.default_rng(seed).random(
        (batch, 3, 32, 32)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(STACKS))
def both(request):
    """One stack in both packages on JAX's weights: (block type, JAX
    modules, JAX params, JAX activations per unit (inputs first), port
    stack)."""
    block = request.param
    jax_units = jres.resnet_layer_configs(block, STACKS[block])
    port_units = tres.resnet_layer_configs(block, STACKS[block])
    x = _images(0)
    jstack = jax_build(jax_units)
    params = jax.device_get(jstack.init(jax.random.key(0), x))
    acts = [x]
    for module, p in zip(jstack.modules, params):
        acts.append(np.asarray(module.apply({"params": p}, acts[-1])))
    tstack = build_layer_stack(port_units)
    for module, sd in zip(tstack.layers, params_from_jax(params,
                                                         port_units)):
        module.load_state_dict(sd, strict=True)
    return block, acts, tstack


def _nchw(a):
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def test_layer_configs_are_jax_dicts_with_input_widths():
    for block, stages in (("BasicBlock", [2, 2, 2, 2]),
                          ("BottleNeck", [3, 4, 6, 3])):
        port = tres.resnet_layer_configs(block, stages, num_classes=7)
        ref = jres.resnet_layer_configs(block, stages, num_classes=7)
        widths = [u.pop("in_features") for u in port[1:]]
        assert port == ref
        expansion = 1 if block == "BasicBlock" else 4
        assert widths == [64, 64 * expansion, 128 * expansion,
                          256 * expansion, 512 * expansion]


@pytest.mark.parametrize("unit", range(6),
                         ids=["head", "stage1", "stage2", "stage3", "stage4",
                              "tail"])
def test_unit_matches_jax(both, unit):
    _, acts, tstack = both
    x = acts[unit] if unit == 0 else _nchw(acts[unit])  # images are NCHW
    x = torch.from_numpy(np.ascontiguousarray(x))
    with torch.no_grad():
        got = tstack.layers[unit](x)
    np.testing.assert_allclose(got.numpy(), _nchw(acts[unit + 1]),
                               **UNIT_TOL)


def test_stack_logits_match_jax_and_head_takes_nhwc(both):
    _, acts, tstack = both
    with torch.no_grad():
        logits = tstack(torch.from_numpy(acts[0]))
        nhwc = tstack(torch.from_numpy(
            np.ascontiguousarray(acts[0].transpose(0, 2, 3, 1))))
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), acts[-1], **UNIT_TOL)
    torch.testing.assert_close(nhwc, logits)


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50",
                                  "resnet101", "resnet152"])
def test_monolithic_models_build_with_jax_parameter_counts(name):
    with torch.device("meta"):
        model = getattr(tres, name)(num_classes=10)
    x = np.zeros((1, 3, 32, 32), np.float32)
    shapes = jax.eval_shape(getattr(jres, name)(num_classes=10).init,
                            jax.random.key(0), x)
    ref = sum(int(np.prod(leaf.shape))
              for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == ref
    if name == "resnet18":
        real = tres.resnet18(num_classes=10)
        assert real(torch.zeros(2, 3, 32, 32)).shape == (2, 10)


# --- three SGD steps through PipelineModel -----------------------------------

LR = 1e-2


def _pool(manager_cls, n):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n)])
    return wm


def _batch():
    ds = CIFAR10Dataset(num_synthetic=8, seed=3)
    return (ds.images,), ds.labels.astype(np.int32)


@pytest.fixture(scope="module")
def jax_steps(devices):
    units = jres.resnet_layer_configs("BasicBlock", [1, 1, 1, 1])
    data, labels = _batch()
    wm = _pool(JaxWorkerManager, 3)
    JaxAllocator(units, wm, None, None).even_allocate()
    ps = JaxParameterServer(units, example_inputs=data,
                            rng=jax.random.key(2))
    port_units = tres.resnet_layer_configs("BasicBlock", [1, 1, 1, 1])
    init = params_from_jax(ps.params, port_units)
    model = JaxPipelineModel(wm, ps, optax.sgd(LR),
                             jlosses.cross_entropy_loss, devices=devices,
                             num_microbatches=2)
    losses = [model.train_step(data, labels, rng=jax.random.key(i))
              for i in range(3)]
    return dict(units=port_units, data=data, labels=labels, init=init,
                losses=losses,
                partition=[len(w.model_config) for w in wm.worker_pool])


def test_three_sgd_steps_match_jax(jax_steps):
    units = jax_steps["units"]
    wm = _pool(WorkerManager, 3)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=jax_steps["init"])
    model = PipelineModel(wm, ps, sgd(LR), cross_entropy_loss, devices=CPU,
                          num_microbatches=2)
    assert model.partition_signature() == jax_steps["partition"]
    data, labels = jax_steps["data"], jax_steps["labels"]
    losses = [model.train_step(data, labels) for _ in range(3)]
    np.testing.assert_allclose(losses, jax_steps["losses"], **TRAIN_TOL)
    assert losses[2] < losses[1] < losses[0]


def test_seeded_init_and_loader_train_the_stack():
    """The parameter server's seeded init covers convolutions and
    GroupNorm; the CIFAR loader feeds ``((images,), labels)`` batches."""
    units = tres.resnet_layer_configs("BasicBlock", [1, 1, 1, 1])
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(0))
    conv = ps.params[1]["block0.conv1.weight"]
    assert conv.shape == (64, 64, 3, 3)
    assert float(conv.std()) == pytest.approx((1 / 576) ** 0.5, rel=0.1)
    assert float(ps.params[1]["block0.norm1.weight"].min()) == 1.0
    loader = build_dataloader_from_cfg(dict(
        dataset_cfg=dict(type="CIFAR10Dataset", num_synthetic=8),
        dataloader_cfg=dict(batch_size=4)))
    (images,), labels = next(iter(loader))
    assert images.shape == (4, 3, 32, 32) and labels.shape == (4,)
    wm = _pool(WorkerManager, 2)
    Allocator(units, wm).even_allocate()
    model = PipelineModel(wm, ps, sgd(LR), cross_entropy_loss, devices=CPU,
                          num_microbatches=2)
    assert np.isfinite(model.train_step((images,), labels))


# --- CIFAR10Dataset ------------------------------------------------------------

def _write_records(path, name, n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    pixels = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
    (path / name).write_bytes(
        np.concatenate([labels[:, None], pixels], axis=1).tobytes())
    return labels, pixels


@pytest.mark.parametrize("train", [True, False])
def test_cifar_binary_records_equal_jax(tmp_path, train):
    _write_records(tmp_path, "data_batch_1.bin", 6, 0)
    _write_records(tmp_path, "data_batch_2.bin", 4, 1)
    labels, pixels = _write_records(tmp_path, "test_batch.bin", 5, 2)
    got = CIFAR10Dataset(data_dir=str(tmp_path), train=train)
    ref = JaxCifar(data_dir=str(tmp_path), train=train)
    assert not got.synthetic and not ref.synthetic
    assert len(got) == len(ref) == (10 if train else 5)
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.images.dtype == ref.images.dtype == np.float32
    assert got.labels.dtype == ref.labels.dtype
    (img,), label = got[3]
    assert img.shape == (3, 32, 32) and label == int(ref[3][1])
    if not train:
        np.testing.assert_array_equal(
            img.reshape(-1), pixels[3].astype(np.float32) / 255.0)
        assert label == int(labels[3])


@pytest.mark.parametrize("kwargs", [dict(), dict(num_synthetic=16, seed=4),
                                    dict(data_dir="missing", train=False)],
                         ids=["defaults", "seed4", "missing_dir"])
def test_cifar_synthetic_fallback_equals_jax(tmp_path, kwargs):
    if kwargs.get("data_dir"):
        kwargs = dict(kwargs, data_dir=str(tmp_path / kwargs["data_dir"]))
    got, ref = CIFAR10Dataset(**kwargs), JaxCifar(**kwargs)
    assert got.synthetic and ref.synthetic
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert len(got) == len(ref)
