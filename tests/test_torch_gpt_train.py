"""GPT's training path in the port against the JAX package (fault C4 in
``ROADMAP.md``): the launcher's config under ``SKYTPU_MODEL``
(``experiment/config.py``'s units, dataset, profiling probe and loss),
``RandomLmDataset``, the full-sequence units on the same weights (moved
with ``params_from_jax``), two SGD steps of tiny GPT through
``PipelineModel``, and each unit type's static profile.  Float32 units
and steps agree at rtol 1e-5 / 1e-4 (another summation order); bfloat16
units at 2e-2 of the output's scale (the two frameworks round the bf16
products in different places)."""

from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.config import load_config as jax_load_config
from skycomputing_tpu.dataset import DataLoader as JaxDataLoader
from skycomputing_tpu.dataset import DataloaderGenerator as JaxLoaderGen
from skycomputing_tpu.dataset.datasets import RandomLmDataset as JaxLm
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ModelBenchmarker as JaxModelBench
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models import gpt as jgpt
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu_torch import build_layer_stack, params_from_jax
from skycomputing_tpu_torch.builder import build_dataloader_from_cfg
from skycomputing_tpu_torch.config import load_config
from skycomputing_tpu_torch.dataset import (
    DataLoader,
    DataloaderGenerator,
    RandomLmDataset,
)
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ModelBenchmarker,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.launch import BatchAdapter
from skycomputing_tpu_torch.models import gpt as tgpt
from skycomputing_tpu_torch.ops import build_loss, causal_lm_loss
from skycomputing_tpu_torch.parallel import PipelineModel, sgd

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CPU = [torch.device("cpu")]
TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
VOCAB, SEQ = 512, 32


def _tiny_cfg(pkg, dtype="float32", dropout=0.0, layers=2):
    return pkg.GptConfig(vocab_size=VOCAB, hidden_size=64,
                         num_hidden_layers=layers, num_attention_heads=2,
                         max_position_embeddings=64, dropout_prob=dropout,
                         dtype=dtype)


def _tiny_units(pkg, dtype="float32", dropout=0.0):
    return pkg.gpt_layer_configs(_tiny_cfg(pkg, dtype, dropout),
                                 deterministic=dropout == 0.0)


def _ids(seed, batch=4, seq=SEQ):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (batch, seq)).astype(np.int32)


# --- RandomLmDataset --------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(num_samples=16),
    dict(num_samples=9, seq_length=20, vocab_size=500, ngram=3, seed=5),
    dict(num_samples=4, seq_length=7, vocab_size=50257, ngram=8, seed=1),
], ids=["defaults", "ngram3", "short_rows"])
def test_random_lm_dataset_equals_jax(kwargs):
    got, ref = RandomLmDataset(**kwargs), JaxLm(**kwargs)
    np.testing.assert_array_equal(got.input_ids, ref.input_ids)
    assert got.input_ids.dtype == ref.input_ids.dtype == np.int32
    assert len(got) == len(ref) == kwargs["num_samples"]
    (row,), label = got[2]
    np.testing.assert_array_equal(row, ref[2][0][0])
    assert label is row  # the labels are the ids (the loss shifts them)


@pytest.mark.parametrize("fixed", [True, False])
def test_lm_probe_and_loader_equal_jax(fixed):
    data_cfg = dict(dataset_cfg=dict(type="RandomLmDataset", num_samples=12,
                                     seq_length=16, vocab_size=300),
                    dataloader_cfg=dict(batch_size=4, shuffle=True))
    port, ref = DataloaderGenerator(data_cfg, fixed=fixed), JaxLoaderGen(
        data_cfg, fixed=fixed)
    for _ in range(4):
        for a, b in zip(port.generate(), ref.generate()):
            np.testing.assert_array_equal(a, b)
    loader = build_dataloader_from_cfg(data_cfg)
    jax_loader = JaxDataLoader(JaxLm(12, 16, 300), batch_size=4,
                               shuffle=True)
    assert isinstance(loader, DataLoader) and len(loader) == 3
    for (data, labels), ((ref_ids,), ref_labels) in zip(BatchAdapter(loader),
                                                        jax_loader):
        # two-element rows pass the launcher's adapter unchanged
        assert len(data) == 1
        np.testing.assert_array_equal(data[0], ref_ids)
        np.testing.assert_array_equal(labels, ref_labels)


# --- the launcher's config: SKYTPU_MODEL (fault C4) --------------------------

@pytest.mark.parametrize("model", ["gpt", "bert", None, "resnet"],
                         ids=["gpt", "bert", "unset", "other"])
def test_launcher_config_follows_skytpu_model_as_experiment_config(
        monkeypatch, tmp_path, model):
    """Under ``SKYTPU_MODEL=gpt`` the port's config builds
    ``experiment/config.py``'s GPT units, ``RandomLmDataset``, the
    ``DataloaderGenerator`` probe and ``CausalLmLoss``; unset, ``bert``
    or any other value gives BERT, as in JAX."""
    for key in ("SKYTPU_GLUE_DIR", "SKYTPU_VOCAB_FILE", "SKYTPU_MODEL",
                "SKYTPU_FLASH", "SKYTPU_LAYER_NUM"):
        monkeypatch.delenv(key, raising=False)
    if model is not None:
        monkeypatch.setenv("SKYTPU_MODEL", model)
    monkeypatch.setenv("SKYTPU_PRESET", "tiny")
    monkeypatch.setenv("SKYTPU_SEQ_LEN", "24")
    monkeypatch.setenv("SKYTPU_BATCH_SIZE", "8")
    monkeypatch.setenv("SKYTPU_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.chdir(ROOT)
    cfg = load_config("skycomputing_tpu_torch/configs/bert_pipeline.py")
    ref = jax_load_config("experiment/config.py")
    assert cfg.model_config == ref.model_config
    assert cfg.data_config == ref.data_config

    def probe(c):
        return c.allocator_config["benchmark_config"]["model"][
            "data_generator_cfg"]

    assert probe(cfg) == probe(ref)
    assert cfg.train_config["loss_cfg"] == ref.train_config["loss_cfg"]
    types = [u["layer_type"] for u in cfg.model_config]
    if model == "gpt":
        assert types == (["GptEmbeddings"] + ["GptBlock_Attn",
                                              "GptBlock_Mlp"] * 10
                         + ["GptLmHead"])
        assert cfg.data_config["dataset_cfg"]["type"] == "RandomLmDataset"
        assert probe(cfg)["generator_type"] == "DataloaderGenerator"
        assert build_loss(cfg.train_config["loss_cfg"]) is causal_lm_loss
        data, labels = next(iter(BatchAdapter(
            build_dataloader_from_cfg(cfg.data_config))))
        assert len(data) == 1 and data[0].shape == (8, 24)
        np.testing.assert_array_equal(data[0], labels)
    else:
        assert types[0] == "BertEmbeddings" and len(types) == 33
        assert cfg.data_config["dataset_cfg"]["type"] == "GlueDataset"
        assert cfg.train_config["loss_cfg"] == dict(type="CrossEntropyLoss")


# --- the full-sequence units on the same weights -----------------------------

def _both(dtype):
    """Tiny GPT in both packages on the same weights: (JAX modules, JAX
    params, port modules)."""
    layer_cfgs = _tiny_units(jgpt, dtype)
    jstack = jax_build(layer_cfgs)
    params = jax.device_get(jstack.init(jax.random.key(3), _ids(0)))
    tstack = build_layer_stack(layer_cfgs)
    for module, sd in zip(tstack.layers, params_from_jax(params,
                                                         layer_cfgs)):
        module.load_state_dict(sd, strict=True)
    return jstack.modules, params, tstack


@pytest.fixture(scope="module")
def tiny():
    return {dtype: _both(dtype) for dtype in ("float32", "bfloat16")}


def _assert_close(got, ref, dtype):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        scale = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 2e-2 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("unit", [0, 1, 2, 5],
                         ids=["embeddings", "attn", "mlp", "lm_head"])
def test_full_sequence_unit_matches_jax(tiny, unit, dtype):
    jmods, params, tstack = tiny[dtype]
    rng = np.random.default_rng(10 + unit)
    if unit == 0:
        x = _ids(unit, batch=3, seq=20)
    else:
        x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    ref = jmods[unit].apply({"params": params[unit]}, x)
    with torch.no_grad():
        got = tstack.layers[unit](torch.from_numpy(x))
    assert str(got.dtype) == f"torch.{ref.dtype}"  # as JAX promotes
    _assert_close(got, ref, dtype)


def test_whole_stack_matches_jax_and_is_causal(tiny):
    """Logits of the whole stack equal JAX's; a later token never moves
    an earlier position's logits (the causal mask)."""
    jmods, params, tstack = tiny["float32"]
    jstack = jax_build(_tiny_units(jgpt))
    ids = _ids(1)
    ref = np.asarray(jstack.apply(params, ids))
    with torch.no_grad():
        got = tstack(torch.from_numpy(ids))
        changed = ids.copy()
        changed[:, 20:] = (changed[:, 20:] + 7) % VOCAB
        later = tstack(torch.from_numpy(changed))
    _assert_close(got, ref, "float32")
    torch.testing.assert_close(got[:, :20], later[:, :20], rtol=0, atol=0)
    assert not torch.allclose(got[:, 20:], later[:, 20:])


# --- training through PipelineModel ------------------------------------------

def _pool(manager_cls, n_workers):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n_workers)
    ])
    return wm


@pytest.fixture(scope="module")
def jax_steps(devices):
    """Two SGD steps of the JAX pipeline (3 workers, even, GPipe M=2):
    the initial and trained weights and the losses."""
    units = _tiny_units(jgpt)
    ids = _ids(2)
    wm = _pool(JaxWorkerManager, 3)
    JaxAllocator(units, wm, None, None).even_allocate()
    ps = JaxParameterServer(units, example_inputs=(ids,),
                            rng=jax.random.key(0))
    init = params_from_jax(ps.params, units)
    model = JaxPipelineModel(wm, ps, optax.sgd(LR), jlosses.causal_lm_loss,
                             devices=devices, num_microbatches=2)
    losses = [model.train_step((ids,), ids, rng=jax.random.key(i))
              for i in range(2)]
    model.sync_to_parameter_server()
    return dict(units=units, ids=ids, init=init, losses=losses,
                trained=params_from_jax(ps.params, units),
                partition=[len(w.model_config) for w in wm.worker_pool])


def _port_model(units, state_dicts=None, schedule="gpipe", seed=0):
    wm = _pool(WorkerManager, 3)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(seed))
    model = PipelineModel(wm, ps, sgd(LR), causal_lm_loss, devices=CPU,
                          num_microbatches=2, schedule=schedule)
    return model, ps


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_two_sgd_steps_match_jax(jax_steps, schedule):
    model, ps = _port_model(jax_steps["units"], jax_steps["init"], schedule)
    assert model.partition_signature() == jax_steps["partition"]
    ids = jax_steps["ids"]
    losses = [model.train_step((ids,), ids) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_steps["losses"], **TOL)
    model.sync_to_parameter_server()
    for got, ref in zip(ps.params, jax_steps["trained"]):
        assert sorted(got) == sorted(ref)
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       **TOL, err_msg=key)


def test_gpt_pipeline_trains():
    """``tests/test_gpt.py::test_gpt_pipeline_trains`` on the port: five
    SGD steps on one batch lower the causal-LM loss."""
    model, _ = _port_model(_tiny_units(tgpt))
    ids = _ids(0)
    losses = [model.train_step((ids,), ids) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_dropout_trains_as_in_train_mode():
    """With dropout on (the launcher's 0.1), the embeddings, attention
    projection and MLP each drop, and the loss stays finite."""
    units = _tiny_units(tgpt, dropout=0.1)
    stack = build_layer_stack(units)
    kinds = {type(m).__name__: type(m.drop).__name__ for m in stack.layers
             if hasattr(m, "drop")}
    assert kinds == dict(GptEmbeddings="Dropout", GptBlock_Attn="Dropout",
                         GptBlock_Mlp="Dropout")
    model, _ = _port_model(units)
    ids = _ids(4)
    assert np.isfinite(model.train_step((ids,), ids))


# --- the static profile ------------------------------------------------------

@pytest.mark.parametrize("dtype, dropout", [
    pytest.param(dtype, dropout, id=f"{dtype}" + ("-dropout" if dropout
                                                  else ""))
    for dropout in (0.0, 0.1) for dtype in ("float32", "bfloat16")
])
def test_static_profile_matches_jax(dtype, dropout):
    """Each GPT unit type profiled statically through the launcher's
    ``DataloaderGenerator`` probe: memory equal, FLOPs within (0.90,
    1.10) of XLA's (the products agree; the elementwise work is charged
    as XLA charges it: dropout's mask, the causal mask's select, the
    float32 softmax and logits casts, bf16 converts)."""
    units = _tiny_units(tgpt, dtype, dropout)
    assert units == _tiny_units(jgpt, dtype, dropout)
    data_cfg = dict(dataset_cfg=dict(type="RandomLmDataset", num_samples=8,
                                     seq_length=16, vocab_size=VOCAB),
                    dataloader_cfg=dict(batch_size=4, shuffle=True))
    bench = ModelBenchmarker(units, DataloaderGenerator(data_cfg))
    flops, mem = bench.benchmark()
    ref_flops, ref_mem = JaxModelBench(units,
                                       JaxLoaderGen(data_cfg)).benchmark()
    assert mem == ref_mem
    assert bench.distinct_units == 4
    assert flops[1:3] == flops[3:5]  # repeated blocks
    for unit, got, want in zip(units, flops, ref_flops):
        assert 0.90 <= got / want <= 1.10, (unit["layer_type"], got / want)
