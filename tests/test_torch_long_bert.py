"""Long-context BERT on one device in the port against the JAX package
(``skycomputing_tpu/models/long_bert.py``): ``LongBertLayer_Head`` at
L=256 on the same weights through the flash wrapper (its plain version
on the CPU) and through the float32 einsum reference, against JAX's
flash path (Pallas in interpret mode) and einsum path at rtol 3e-5 /
atol 3e-6; the long head against the port's ``BertLayer_Head``; the
refusals (attention dropout in train mode, a mesh, another strategy);
``full_attention_reference`` against JAX's; the layer configs; a
2-encoder-unit stack's logits and two SGD steps through
``PipelineModel`` at rtol 1e-4 / atol 1e-6 (the float32 trainer
tolerance of ``tests/test_torch_pipeline.py``); the flash call's
static charge on ``meta`` against XLA's count of the JAX kernel; a
mesh-built head's static profile and ``mesh_allocate`` plan against
JAX's (one device's share of the sharded program, fault C8); and what
the card's long-L bf16 check of B1 can see."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from skycomputing_tpu.builder import build_layer as jax_build_layer
from skycomputing_tpu.dataset import RandomTokenGenerator as JaxTokens
from skycomputing_tpu.dynamics import ModelBenchmarker as JaxModelBench
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models.long_bert import (
    long_bert_layer_configs as jax_long_configs,
)
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu.parallel.ring_attention import (
    full_attention_reference as jax_full_attention,
)
from skycomputing_tpu.utils.profiling import normalize_cost_analysis
from skycomputing_tpu_torch import build_layer, params_from_jax
from skycomputing_tpu_torch.dataset import RandomTokenGenerator
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ModelBenchmarker,
    ParameterServer,
    WorkerManager,
)
from skycomputing_tpu_torch.dynamics.estimator import count_flops
from skycomputing_tpu_torch.models import (
    LongBertLayer_Head,
    bert_config,
    long_bert_layer_configs,
)
from skycomputing_tpu_torch.ops import losses as tlosses
from skycomputing_tpu_torch.ops.flash_attention import (
    BF16_LONG_TOL,
    agreement,
    flash_attention,
    flash_attention_reference,
)
from skycomputing_tpu_torch.parallel import PipelineModel, sgd
from skycomputing_tpu_torch.parallel.mesh import make_1d_mesh
from skycomputing_tpu_torch.parallel.ring_attention import (
    full_attention_reference,
)

pytestmark = pytest.mark.torch_port

HEAD_TOL = dict(rtol=3e-5, atol=3e-6)
DEFAULT_RATIO = (0.90, 1.10)  # tests/test_torch_dynamics.py's FLOP ratio
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
CPU = [torch.device("cpu")]
L = 256


def _cfg(pkg_config, **kw):
    base = dict(dtype="float32", hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0,
                max_position_embeddings=L)
    base.update(kw)
    return pkg_config("tiny", **base)


def _hidden_and_mask(seed, valid=200):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(2, L, 128)).astype(np.float32)
    mask4 = np.zeros((2, 1, 1, L), np.float32)
    mask4[:, :, :, valid:] = -10000.0  # a padded tail
    return hidden, mask4


@pytest.fixture(scope="module")
def heads():
    """JAX's head at L=256 on its flash and einsum paths, its weights,
    and the inputs."""
    cfg = _cfg(jax_bert_config).to_dict()
    hidden, mask4 = _hidden_and_mask(3)
    flash = jax_build_layer("LongBertLayer_Head", config=cfg,
                            deterministic=True)
    einsum = jax_build_layer("LongBertLayer_Head", config=cfg,
                             deterministic=True, use_flash=False)
    variables = flash.init({"params": jax.random.key(0)}, hidden, mask4)
    params = jax.device_get(variables["params"])
    out = {name: np.asarray(m.apply(variables, hidden, mask4)[0])
           for name, m in (("flash", flash), ("einsum", einsum))}
    return dict(params=params, hidden=hidden, mask4=mask4, out=out)


def _port_head(params, config=None, **kw):
    cfg = (config or _cfg(bert_config)).to_dict()
    units = [dict(layer_type="LongBertLayer_Head", config=cfg,
                  deterministic=True, **kw)]
    head = build_layer("LongBertLayer_Head", config=cfg, deterministic=True,
                       **kw)
    head.load_state_dict(params_from_jax([params], units)[0], strict=True)
    return head


@pytest.mark.parametrize("jax_path", ["flash", "einsum"])
@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["port_flash", "port_einsum"])
def test_head_matches_jax(heads, use_flash, jax_path):
    head = _port_head(heads["params"], use_flash=use_flash)
    assert head.self.use_flash is use_flash
    with torch.no_grad():
        out, mask = head(torch.from_numpy(heads["hidden"]),
                         torch.from_numpy(heads["mask4"]))
    np.testing.assert_allclose(out.numpy(), heads["out"][jax_path],
                               **HEAD_TOL)
    np.testing.assert_array_equal(mask.numpy(), heads["mask4"])


def test_long_head_matches_standard_head(heads):
    """A ``BertLayer_Head`` state dict loads into the long head
    unchanged, and both give one output."""
    long_head = _port_head(heads["params"])
    cfg = _cfg(bert_config).to_dict()
    std = build_layer("BertLayer_Head", config=cfg, deterministic=True)
    std.load_state_dict(long_head.state_dict(), strict=True)
    x = torch.from_numpy(heads["hidden"])
    m = torch.from_numpy(heads["mask4"])
    with torch.no_grad():
        np.testing.assert_allclose(long_head(x, m)[0].numpy(),
                                   std(x, m)[0].numpy(), **HEAD_TOL)


def test_attention_dropout_in_train_mode_raises():
    cfg = _cfg(bert_config, attention_probs_dropout_prob=0.1).to_dict()
    x = torch.zeros(1, 8, 128)
    m = torch.zeros(1, 1, 1, 8)
    head = build_layer("LongBertLayer_Head", config=cfg)
    with pytest.raises(ValueError, match="attention-probs dropout"):
        head(x, m)
    head.eval()  # no dropout drawn in eval mode
    assert head(x, m)[0].shape == (1, 8, 128)
    fixed = build_layer("LongBertLayer_Head", config=cfg,
                        deterministic=True)
    assert fixed(x, m)[0].shape == (1, 8, 128)


@pytest.mark.parametrize("kw", [dict(), dict(strategy="ulysses")],
                         ids=["mesh", "ulysses"])
def test_sequence_parallel_raises_naming_its_item(devices, kw):
    """Sequence parallelism is ported: a head with a mesh runs ring
    attention (Ulysses with ``strategy="ulysses"``) and gives the
    single-device head's output; only an unknown strategy raises, with
    JAX's ``ValueError``, at its first forward."""
    cfg = _cfg(bert_config, num_attention_heads=8).to_dict()
    hidden, mask4 = (torch.from_numpy(a) for a in _hidden_and_mask(7))
    head = build_layer("LongBertLayer_Head", config=cfg, deterministic=True,
                       mesh=_mesh(4), **kw)
    single = build_layer("LongBertLayer_Head", config=cfg,
                         deterministic=True, use_flash=False)
    single.load_state_dict(head.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(head(hidden, mask4)[0].numpy(),
                                   single(hidden, mask4)[0].numpy(),
                                   **HEAD_TOL)
    bogus = build_layer("LongBertLayer_Head", config=cfg, mesh=_mesh(4),
                        strategy="bogus", deterministic=True)
    jax_bogus = jax_build_layer(
        "LongBertLayer_Head", config=_cfg(jax_bert_config).to_dict(),
        deterministic=True, mesh=JaxMesh(np.array(devices[:4]), ("sp",)),
        strategy="bogus")
    with pytest.raises(ValueError, match="strategy 'bogus'") as jax_err:
        jax_bogus.init({"params": jax.random.key(0)}, hidden.numpy(),
                       mask4.numpy())
    with pytest.raises(ValueError, match="strategy 'bogus'") as err:
        bogus(hidden, mask4)
    assert str(err.value) == str(jax_err.value)


def _mesh(S):
    return make_1d_mesh(S, "sp", [torch.device("cpu")] * S)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_mesh_head_matches_jax(devices, strategy, S):
    """``LongBertLayer_Head(mesh=..., strategy=...)`` on the JAX head's
    weights: JAX over its first S devices, the port over S CPU
    positions, L=256 with a padded tail (8 heads, so Ulysses divides)."""
    cfg = _cfg(jax_bert_config, num_attention_heads=8).to_dict()
    hidden, mask4 = _hidden_and_mask(11 + S)
    jmesh = JaxMesh(np.array(devices[:S]), ("sp",))
    ref_head = jax_build_layer("LongBertLayer_Head", config=cfg,
                               deterministic=True, mesh=jmesh,
                               strategy=strategy)
    variables = ref_head.init({"params": jax.random.key(S)}, hidden, mask4)
    ref = np.asarray(jax.jit(ref_head.apply)(variables, hidden, mask4)[0])
    head = _port_head(jax.device_get(variables["params"]),
                      config=_cfg(bert_config, num_attention_heads=8),
                      mesh=_mesh(S), strategy=strategy)
    with torch.no_grad():
        out, _ = head(torch.from_numpy(hidden), torch.from_numpy(mask4))
    np.testing.assert_allclose(out.numpy(), ref, **HEAD_TOL)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_mesh_head_grads_match_single_device(strategy):
    """Autograd through the positions' moves: the mesh head's parameter
    and input gradients equal the single-device einsum head's."""
    cfg = _cfg(bert_config, num_attention_heads=8).to_dict()
    hidden, mask4 = (torch.from_numpy(a) for a in _hidden_and_mask(9))
    head = build_layer("LongBertLayer_Head", config=cfg, deterministic=True,
                       mesh=_mesh(4), strategy=strategy)
    single = build_layer("LongBertLayer_Head", config=cfg,
                         deterministic=True, use_flash=False)
    single.load_state_dict(head.state_dict())
    # a seeded projection of the output (a sum of squares would be
    # constant under the LayerNorm)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(hidden.shape)).astype(np.float32))
    grads = []
    for module in (head, single):
        x = hidden.clone().requires_grad_(True)
        names, params = zip(*module.named_parameters())
        loss = (module(x, mask4)[0] * w).sum()
        grads.append(dict(zip(("x",) + names, torch.autograd.grad(
            loss, (x,) + params))))
    for name, a in grads[0].items():
        b = grads[1][name]
        if name == "self.key.bias":
            # zero in exact arithmetic (a softmax ignores a constant per
            # query): both are rounding
            assert a.abs().max() < 1e-4 and b.abs().max() < 1e-4
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-6, err_msg=name)


def test_mesh_head_rejects_attention_dropout():
    """The online softmax cannot drop probabilities: with a mesh too,
    attention dropout in train mode raises."""
    cfg = _cfg(bert_config, attention_probs_dropout_prob=0.1).to_dict()
    head = build_layer("LongBertLayer_Head", config=cfg, mesh=_mesh(2))
    with pytest.raises(ValueError, match="attention-probs dropout"):
        head(torch.zeros(1, 16, 128), torch.zeros(1, 1, 1, 16))
    head.eval()
    assert head(torch.zeros(1, 16, 128),
                torch.zeros(1, 1, 1, 16))[0].shape == (1, 16, 128)


def _mesh_cfg(pkg_config):
    return _cfg(pkg_config, hidden_dropout_prob=0.1, num_attention_heads=8)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_mesh_head_static_profile_equals_jax(devices, strategy, S):
    """A mesh-built stack profiles on ``meta`` without touching the
    mesh's devices, and charges what JAX's profile charges (fault C8):
    the head runs one position's program, as XLA counts one device's
    share of the ``shard_map``'d program (and the ring's ``scan`` body
    once), so its FLOPs lie within DEFAULT_RATIO of JAX's (the whole
    work is 2-14 times that); memory equals JAX's; every other unit is
    charged as in the single-device stack."""
    port = ModelBenchmarker(long_bert_layer_configs(
        _mesh_cfg(bert_config), 1, _mesh(S), strategy=strategy),
        RandomTokenGenerator(2, L, 1024))
    flops, mem = port.benchmark()
    single_units = long_bert_layer_configs(_mesh_cfg(bert_config), 1)
    single_units[1]["use_flash"] = False
    single, _ = ModelBenchmarker(single_units,
                                 RandomTokenGenerator(2, L, 1024)).benchmark()
    head = 1  # embeddings, then the head
    assert flops[:head] + flops[head + 1:] == single[:head] + single[head + 1:]
    jax_flops, jax_mem = JaxModelBench(
        jax_long_configs(_mesh_cfg(jax_bert_config), 1,
                         JaxMesh(np.array(devices[:S]), ("sp",)),
                         strategy=strategy),
        JaxTokens(2, L, 1024)).benchmark()
    assert mem == jax_mem
    assert len(jax_flops) == len(flops)
    ratio = flops[head] / jax_flops[head]
    assert DEFAULT_RATIO[0] <= ratio <= DEFAULT_RATIO[1], ratio
    assert flops[head] * S < 1.5 * single[head]  # not the whole work


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_mesh_head_meta_path_keeps_shapes_and_refusals(strategy):
    """On ``meta`` the mesh-built head returns the whole output's shape
    and gradients of its inputs' shapes (what the pre-flight reads), and
    refuses what the engines refuse."""
    head = build_layer("LongBertLayer_Head",
                       config=_mesh_cfg(bert_config).to_dict(),
                       mesh=_mesh(4), strategy=strategy).to("meta")
    hidden = torch.empty(2, L, 128, device="meta", requires_grad=True)
    mask4 = torch.empty(2, 1, 1, L, device="meta", requires_grad=True)
    out, mask_out = head(hidden, mask4)
    assert out.shape == hidden.shape and mask_out is mask4
    grads = torch.autograd.grad((out.sum(), mask_out.sum()),
                                (hidden, mask4))
    assert [g.shape for g in grads] == [hidden.shape, mask4.shape]
    with pytest.raises(ValueError, match="divisible"):
        head(torch.empty(2, L - 2, 128, device="meta"),
             torch.empty(2, 1, 1, L - 2, device="meta"))
    head.self.strategy = "bogus"
    with pytest.raises(ValueError, match="strategy 'bogus'"):
        head(hidden, mask4)


class _EqualDevices:
    """Device profiles of equal workers, keyed by current rank."""

    def __init__(self, wm):
        self._wm = wm

    def benchmark(self):
        return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                for w in self._wm.worker_pool}


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_mesh_stack_mesh_allocate_equals_jax(devices, strategy):
    """``Allocator.mesh_allocate`` over a 2-encoder-unit long-BERT stack
    whose heads are mesh-built over 8 positions, 8 equal devices, at
    most 4 stages of 2 chips, on each package's static profile: the same
    stages, slices and chips (with the heads' whole work charged, the
    port split the stack one unit earlier)."""
    S = 8
    plans = []
    for manager_cls, alloc_cls, bench_cls, units, gen in (
            (JaxWorkerManager, JaxAllocator, JaxModelBench,
             jax_long_configs(_mesh_cfg(jax_bert_config), 2,
                              JaxMesh(np.array(devices[:S]), ("sp",)),
                              strategy=strategy),
             JaxTokens(2, L, 1024)),
            (WorkerManager, Allocator, ModelBenchmarker,
             long_bert_layer_configs(_mesh_cfg(bert_config), 2, _mesh(S),
                                     strategy=strategy),
             RandomTokenGenerator(2, L, 1024))):
        wm = _pool(manager_cls, 8)
        alloc = alloc_cls(units, wm, bench_cls(units, gen),
                          _EqualDevices(wm))
        alloc.mesh_allocate(num_devices=8, max_stages=4,
                            max_chips_per_stage=2)
        plan = alloc.last_mesh
        plans.append((plan.num_stages, [tuple(s) for s in plan.slices],
                      list(plan.chips), sorted(
                          (w.order, len(w.model_config or []),
                           w.extra_config.get("mesh_chips"))
                          for w in wm.worker_pool)))
    assert plans[1] == plans[0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_reference_matches_jax(causal, dtype):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
               for _ in range(3))
    bias = np.where(np.arange(24)[None] < 20, 0.0, -1e4).astype(
        np.float32).repeat(2, 0)
    jdt = jnp.dtype(dtype)
    ref = jax_full_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             causal=causal, bias=jnp.asarray(bias, jdt))
    tdt = getattr(torch, dtype)
    got = full_attention_reference(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        bias=torch.from_numpy(bias).to(tdt))
    assert got.dtype == tdt
    tol = HEAD_TOL if dtype == "float32" else dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("deterministic", [True, False])
def test_layer_configs_equal_jax(deterministic):
    port = long_bert_layer_configs(_cfg(bert_config), 3,
                                   deterministic=deterministic)
    ref = jax_long_configs(_cfg(jax_bert_config), 3, None,
                           deterministic=deterministic)
    assert port == ref
    assert [u["layer_type"] for u in port].count("LongBertLayer_Head") == 3


# --- two SGD steps through PipelineModel -------------------------------------

SEQ, LR = 128, 1e-2


def _units(pkg_config, pkg_configs, jax_side):
    cfg = _cfg(pkg_config, max_position_embeddings=SEQ)
    if jax_side:
        return pkg_configs(cfg, 2, None, deterministic=True)
    return pkg_configs(cfg, 2, deterministic=True)


def _batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 1024, size=(4, SEQ)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 100:] = 0
    mask[3, 64:] = 0
    labels = rng.integers(0, 3, size=(4,)).astype(np.int32)
    return (ids, np.zeros_like(ids), mask), labels


def _pool(manager_cls, n):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i))
        for i in range(n)])
    return wm


@pytest.fixture(scope="module")
def jax_steps(devices):
    units = _units(jax_bert_config, jax_long_configs, True)
    data, labels = _batch()
    wm = _pool(JaxWorkerManager, 3)
    JaxAllocator(units, wm, None, None).even_allocate()
    ps = JaxParameterServer(units, example_inputs=data,
                            rng=jax.random.key(1))
    init = params_from_jax(ps.params, units)
    model = JaxPipelineModel(wm, ps, optax.sgd(LR),
                             jlosses.cross_entropy_loss, devices=devices,
                             num_microbatches=2)
    logits = np.asarray(model.forward(data))
    losses = [model.train_step(data, labels, rng=jax.random.key(i))
              for i in range(2)]
    return dict(units=units, data=data, labels=labels, init=init,
                logits=logits, losses=losses)


def test_two_encoder_stack_trains_as_jax(jax_steps):
    units = _units(bert_config, long_bert_layer_configs, False)
    assert units == jax_steps["units"]
    wm = _pool(WorkerManager, 3)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=jax_steps["init"])
    model = PipelineModel(wm, ps, sgd(LR), tlosses.cross_entropy_loss,
                          devices=CPU, num_microbatches=2)
    data, labels = jax_steps["data"], jax_steps["labels"]
    np.testing.assert_allclose(model.forward(data).numpy(),
                               jax_steps["logits"], rtol=1e-4, atol=1e-5)
    losses = [model.train_step(data, labels) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_steps["losses"], **TRAIN_TOL)
    assert losses[1] < losses[0]


@pytest.mark.parametrize("strategy, S", [("ring", 4), ("ulysses", 2)])
def test_mesh_stack_trains_as_jax(jax_steps, strategy, S):
    """The same stack with every head sequence-parallel over S CPU
    positions gives JAX's single-device logits and two SGD losses."""
    cfg = _cfg(bert_config, max_position_embeddings=SEQ)
    units = long_bert_layer_configs(cfg, 2, _mesh(S), deterministic=True,
                                    strategy=strategy)
    wm = _pool(WorkerManager, 3)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=jax_steps["init"])
    model = PipelineModel(wm, ps, sgd(LR), tlosses.cross_entropy_loss,
                          devices=CPU, num_microbatches=2)
    data, labels = jax_steps["data"], jax_steps["labels"]
    np.testing.assert_allclose(model.forward(data).numpy(),
                               jax_steps["logits"], rtol=1e-4, atol=1e-5)
    losses = [model.train_step(data, labels) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_steps["losses"], **TRAIN_TOL)


def test_seeded_init_draws_the_long_head():
    """The parameter server's seeded init covers the long head (the
    standard head's tree)."""
    units = _units(bert_config, long_bert_layer_configs, False)
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(0))
    head = ps.params[1]
    assert sorted(head) == sorted(build_layer(
        "BertLayer_Head", config=units[1]["config"]).state_dict())
    assert float(head["self.query.weight"].std()) == pytest.approx(
        0.02, rel=0.1)


# --- the flash call's static charge ------------------------------------------

def _xla_flash_flops(B, L_, H, D):
    a = jax.ShapeDtypeStruct((B, L_, H, D), jnp.float32)
    b = jax.ShapeDtypeStruct((B, L_), jnp.float32)
    compiled = jax.jit(lambda q, k, v, bias: jax_flash_attention(
        q, k, v, bias)).lower(a, a, a, b).compile()
    return float(normalize_cost_analysis(
        compiled.cost_analysis()).get("flops", 0.0))


@pytest.mark.parametrize("B, L_, H, D", [(2, 16, 2, 64), (2, 256, 2, 64),
                                         (1, 512, 4, 32), (2, 768, 2, 64),
                                         (1, 2048, 2, 64)])
def test_meta_flash_charge_equals_xla(B, L_, H, D):
    """On ``meta`` the wrapper charges one grid cell of the JAX kernel,
    as XLA's cost analysis counts its interpret-mode loop on the CPU
    (fault C5 in ``ROADMAP.md``): within 3% of XLA's count, whatever B
    and H; the output and the gradients keep their shapes."""
    q, k, v = (torch.empty(B, L_, H, D, device="meta", requires_grad=True)
               for _ in range(3))
    bias = torch.empty(B, L_, device="meta")
    out, flops = count_flops(lambda *a: flash_attention(*a), (q, k, v,
                                                               bias))
    assert out.shape == q.shape and out.device.type == "meta"
    assert flops / _xla_flash_flops(B, L_, H, D) == pytest.approx(1.0,
                                                                  abs=0.03)
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert all(g.shape == q.shape for g in grads)


def _tile_softmax(L_, tail, fault, heads=4, seed=702):
    """B1's bf16 arithmetic at B=1, D=64 with the last ``tail`` keys
    padded (float32 scores and online-softmax sums, P rounded to bf16
    before P.V, the output rounded to bf16), with ``fault`` in the last
    64-key tile that holds real keys (the tile loop's edge) or none, and
    the plain version's output on the same inputs."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L_, heads, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    bias = torch.zeros(1, L_)
    bias[:, -tail:] = -10000.0
    bias = bias.bfloat16()
    ref = flash_attention_reference(q, k, v, bias, 64 ** -0.5)
    edge = slice((L_ - tail) // 64 * 64, (L_ - tail) // 64 * 64 + 64)
    out = torch.empty_like(ref)
    for h in range(heads):
        s = (q[0, :, h].float() * 64 ** -0.5) @ k[0, :, h].float().T
        p = torch.exp(s + bias[0].float()
                      - (s + bias[0].float()).max(-1, keepdim=True).values)
        l = p.sum(-1, keepdim=True)
        if fault == "tile_skipped":
            l = l - p[:, edge].sum(-1, keepdim=True)
            p[:, edge] = 0
        elif fault == "sum_misses_tile":
            l = l - p[:, edge].sum(-1, keepdim=True)
        elif fault == "accumulator_misses_tile":
            p[:, edge] = 0
        out[0, :, h] = ((p.bfloat16().float() @ v[0, :, h].float()) / l
                        ).bfloat16()
    return out, ref


@pytest.mark.parametrize("L_, tail", [(1024, 102), (4096, 409)])
def test_long_bf16_check_passes_the_kernels_rounding(L_, tail):
    """B1's own bf16 rounding at long BERT's lengths lies inside
    ``BF16_LONG_TOL`` (at about a quarter of the largest-error bound and
    half of the RMS bound)."""
    got = agreement(*_tile_softmax(L_, tail, None))
    assert all(got[k] <= tol for k, tol in BF16_LONG_TOL.items()), got


@pytest.mark.parametrize("fault", ["tile_skipped", "sum_misses_tile",
                                   "accumulator_misses_tile"])
def test_long_bf16_check_refuses_a_fault_in_one_key_tile(fault):
    """A fault in one key tile of 64 at L=4,096 moves outputs that
    average ~3,700 keys by less than the absolute 2e-2 held at L=128
    (the sum missing a tile: about 6e-3), yet breaks a bound of
    ``BF16_LONG_TOL``."""
    got = agreement(*_tile_softmax(4096, 409, fault))
    assert any(got[k] > tol for k, tol in BF16_LONG_TOL.items()), got
