"""Mesh-native stages in the port (``parallel/mesh.py``,
``parallel/mesh_pipeline.py``, ``dynamics/solver.py:solve_mesh_shapes``,
``Allocator.mesh_allocate`` / ``refine_mesh_allocation`` and
``analysis/plan_check.py:verify_mesh_payload``) against the JAX
package: the mesh helpers' shapes and refusals; the mesh-shape search
over a seeded grid; the allocator's partitions and ``mesh_chips``; the
payload validator's problem lists; ``MeshPipelineModel`` bitwise equal
to ``PipelineModel`` at one position per stage, within 1e-6 of it at
two, within 1e-5 of JAX's ``MeshPipelineModel`` at two (and with
``tp=2``); a mixture-of-experts stack, whose units couple rows, equal
to JAX's mesh engine at two positions per stage; an indivisible
microbatch refused."""

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu.analysis.plan_check import (
    verify_mesh_payload as jax_verify_mesh_payload,
)
from skycomputing_tpu.dynamics import Allocator as JaxAllocator
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.dynamics.solver import (
    solve_mesh_shapes as jax_solve_mesh_shapes,
)
from skycomputing_tpu.models import bert_config as jax_bert_config
from skycomputing_tpu.models import bert_layer_configs as jax_bert_layers
from skycomputing_tpu.models import gpt as jgpt
from skycomputing_tpu.ops import cross_entropy_loss as jax_ce
from skycomputing_tpu.ops import losses as jlosses
from skycomputing_tpu.parallel import mesh as jax_mesh
from skycomputing_tpu.parallel import MeshPipelineModel as JaxMeshPipeline
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch.analysis import verify_mesh_payload
from skycomputing_tpu_torch.dynamics import (
    Allocator,
    ParameterServer,
    WorkerManager,
    solve_mesh_shapes,
)
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
from skycomputing_tpu_torch.models import gpt as tgpt
from skycomputing_tpu_torch.ops.losses import causal_lm_loss, cross_entropy_loss
from skycomputing_tpu_torch.parallel import (
    MeshPipelineModel,
    PipelineModel,
    mesh as tmesh,
    sgd,
)

pytestmark = pytest.mark.torch_port

CPUS = [torch.device("cpu")] * 8
LR = 1e-2
_OPT = optax.sgd(LR)  # one optimizer: JAX's stage programs cache on it


# --- the mesh helpers ---------------------------------------------------------

HELPER_CALLS = [
    ("make_1d_mesh", (4, "sp")), ("make_1d_mesh", (9, "sp")),
    ("make_pipeline_mesh", (3,)), ("make_dp_pp_mesh", (2, 4)),
    ("make_dp_pp_mesh", (3, 3)), ("make_dp_pp_tp_mesh", (2, 2, 2)),
    ("make_dp_pp_tp_mesh", (1, 3, 3)),
    ("stage_submeshes", ([2, 2, 4],)), ("stage_submeshes", ([2, 4], 2)),
    ("stage_submeshes", ([2, 3], 2)), ("stage_submeshes", ([],)),
    ("stage_submeshes", ([2, 0],)), ("stage_submeshes", ([1], 0)),
    ("stage_submeshes", ([4, 4, 1],)),
]  # stage_submeshes's second argument is tp


def _shape_or_error(fn, args, devices):
    if fn.__name__ == "stage_submeshes" and len(args) == 2:
        args, kw = args[:1], dict(tp=args[1])
    else:
        kw = {}
    try:
        out = fn(*args, devices=devices, **kw)
    except ValueError as exc:
        return "error", str(exc)
    meshes = out if isinstance(out, list) else [out]
    return "ok", [(tuple(m.axis_names), dict(m.shape),
                   [str(d) for d in np.asarray(m.devices).flatten()])
                  for m in meshes]


@pytest.mark.parametrize("name, args", HELPER_CALLS,
                         ids=[f"{n}{a}" for n, a in HELPER_CALLS])
def test_mesh_helpers_match_jax(devices, name, args):
    """Shapes, axis names and device order of every helper, and its
    refusals word for word (device names aside: the port's positions
    are CPU positions, JAX's its CPU devices)."""
    ref = _shape_or_error(getattr(jax_mesh, name), args, devices)
    got = _shape_or_error(getattr(tmesh, name), args, CPUS)
    assert got[0] == ref[0]
    if got[0] == "error":
        assert got[1] == ref[1]
        return
    for (axes, shape, devs), (raxes, rshape, rdevs) in zip(got[1], ref[1]):
        assert (axes, shape) == (raxes, rshape)
        assert devs == ["cpu"] * len(rdevs)


def test_mesh_without_devices_wants_a_card():
    """``devices=None`` means every CUDA device: with no card it raises,
    never falling back to the CPU."""
    if torch.cuda.is_available():
        assert tmesh.make_1d_mesh(1, "sp").devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_1d_mesh(1, "sp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.stage_submeshes([1])


# --- the mesh-shape search and the allocator ---------------------------------

def _result(r):
    return (r.slices, r.chips, r.stage_costs, r.bottleneck, r.num_devices,
            r.stage_overhead)


def test_solve_mesh_shapes_equals_jax():
    """Over a seeded grid of layer costs, memories, devices, caps and
    overheads: the same result, or the same refusal."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        L = int(rng.integers(1, 24))
        cost = rng.uniform(0.1, 5.0, L).round(3).tolist()
        mem = rng.uniform(0.5, 3.0, L).round(2).tolist()
        kw = dict(
            num_devices=int(rng.integers(1, 17)),
            layer_mem=mem if rng.random() < 0.5 else None,
            mem_per_chip=float(rng.uniform(2.0, 12.0)),
            max_stages=[None, 2, 4][int(rng.integers(3))],
            max_chips_per_stage=[None, 1, 2, 4][int(rng.integers(4))],
            stage_overhead=[0.0, 0.05, 1.0][int(rng.integers(3))])
        try:
            ref = _result(jax_solve_mesh_shapes(cost, **kw))
        except (ValueError, RuntimeError) as exc:
            with pytest.raises(type(exc)) as err:
                solve_mesh_shapes(cost, **kw)
            assert str(err.value) == str(exc)
            continue
        assert _result(solve_mesh_shapes(cost, **kw)) == ref


def test_solve_mesh_shapes_contract():
    """``tests/test_mesh_pipeline.py``'s contract on the port's copy."""
    r = solve_mesh_shapes([1.0] * 12, 8, max_chips_per_stage=2)
    assert r.slices == [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert r.chips == [2, 2, 2, 2] and r.bottleneck == pytest.approx(1.5)
    r = solve_mesh_shapes([6.0, 1.0, 1.0, 1.0, 1.0], 8, max_stages=5)
    heavy = max(range(r.num_stages), key=lambda i: r.stage_costs[i])
    assert r.chips[heavy] == max(r.chips) and sum(r.chips) <= 8
    free = solve_mesh_shapes([1.0] * 12, 8, max_chips_per_stage=1)
    taxed = solve_mesh_shapes([1.0] * 12, 8, max_chips_per_stage=1,
                              stage_overhead=1.0)
    assert taxed.num_stages < free.num_stages
    assert solve_mesh_shapes([1.0] * 12, 8).num_stages == 1
    with pytest.raises(RuntimeError, match="infeasible"):
        solve_mesh_shapes([1.0] * 4, 2, layer_mem=[10.0] * 4,
                          mem_per_chip=15.0)


def _mesh_world(manager_cls, alloc_cls, costs, n_workers=8):
    n_layers = len(costs)
    wm = manager_cls()
    wm.load_worker_pool_from_config(
        [dict(name=f"n{i}", device_config=dict(device_index=i))
         for i in range(n_workers)])

    class _Dev:
        def benchmark(self):
            return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                    for w in wm.worker_pool}

    class _Mod:
        def benchmark(self):
            return list(costs), [0.1] * n_layers

    units = [dict(layer_type="Linear_Proxy", idx=i) for i in range(n_layers)]
    return alloc_cls(units, wm, _Mod(), _Dev()), wm


def _mesh_state(wm):
    staged = sorted((w for w in wm.worker_pool if w.model_config),
                    key=lambda w: w.order)
    return ([(w.name, w.rank, w.order, w.model_config[0]["idx"],
              len(w.model_config), w.extra_config["mesh_chips"])
             for w in staged],
            sorted(w.name for w in wm.worker_pool
                   if not w.model_config and "mesh_chips" in w.extra_config))


@pytest.mark.parametrize("costs, kw, measured", [
    ([1.0] * 12, dict(max_chips_per_stage=2), [3.0, 1.0, 1.0, 1.0]),
    ([3.0, 1.0, 1.0, 2.0, 1.0, 1.0, 4.0, 1.0, 1.0], dict(stage_overhead=0.2),
     None),
    ([1.0, 2.0] * 5, dict(max_stages=3, max_chips_per_stage=3), None),
], ids=["uniform", "skewed", "capped"])
def test_mesh_allocate_writes_chips_and_refines_as_jax(costs, kw, measured):
    """``mesh_allocate`` writes JAX's partition, pipeline order and
    ``mesh_chips`` (clearing it on idle workers), and
    ``refine_mesh_allocation`` over measured stage times re-solves as
    JAX's does: a slow stage sheds layers."""
    states = []
    for manager_cls, alloc_cls in ((JaxWorkerManager, JaxAllocator),
                                   (WorkerManager, Allocator)):
        alloc, wm = _mesh_world(manager_cls, alloc_cls, costs)
        alloc.mesh_allocate(**kw)
        first = _mesh_state(wm)
        times = measured or [1.0 + 0.5 * i for i in range(len(first[0]))]
        alloc.refine_mesh_allocation(times, damping=1.0)
        states.append((first, _mesh_state(wm), alloc.last_mesh.chips))
    assert states[1] == states[0]
    assert not states[1][0][1] and not states[1][1][1]
    if measured:  # stage 0 read 3x slow
        assert states[1][1][0][0][4] < states[1][0][0][0][4]


# --- the payload validator ----------------------------------------------------

PAYLOADS = [
    {"chips_per_stage": [2, 2, 1], "num_devices": 8, "tp": 1},
    "nope",
    {"chips_per_stage": [], "num_devices": 4},
    {"chips_per_stage": [2, 0], "num_devices": 4},
    {"chips_per_stage": [4, 4], "num_devices": 4},
    {"chips_per_stage": [2, 3], "num_devices": 8, "tp": 2},
    {"chips_per_stage": [2, 2], "num_devices": 8, "microbatch_rows": 4},
    {"chips_per_stage": [4, 2], "num_devices": 8, "microbatch_rows": 6},
    {"chips_per_stage": [2], "num_devices": 8, "microbatch_rows": 0},
    {"chips_per_stage": [True, 2.0], "num_devices": "8", "tp": 0},
    {"chips_per_stage": None, "num_devices": None, "microbatch_rows": 3},
]


@pytest.mark.parametrize("payload", PAYLOADS,
                         ids=[str(i) for i in range(len(PAYLOADS))])
def test_verify_mesh_payload_equals_jax(payload):
    assert verify_mesh_payload(payload) == jax_verify_mesh_payload(payload)


def test_verify_mesh_payload_contract():
    assert verify_mesh_payload(PAYLOADS[0]) == []
    assert any("must fit" in p for p in verify_mesh_payload(PAYLOADS[4]))
    assert any("tp=2" in p for p in verify_mesh_payload(PAYLOADS[5]))
    assert verify_mesh_payload(PAYLOADS[6]) == []
    assert any("does not divide" in p
               for p in verify_mesh_payload(PAYLOADS[7]))


# --- the mesh-native engine ---------------------------------------------------

def _units(pkg_config, pkg_layers, units=2):
    cfg = pkg_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    return pkg_layers(cfg, num_encoder_units=units, num_classes=3,
                      deterministic=True)


def _pool(manager_cls, n_workers, mesh_chips=None):
    wm = manager_cls()
    wm.load_worker_pool_from_config(
        [dict(name=f"n{i}", device_config=dict(device_index=i),
              extra_config=(dict(mesh_chips=mesh_chips[i])
                            if mesh_chips is not None else {}))
         for i in range(n_workers)])
    return wm


def _batch(seed=0, batch=8, seq=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, size=(batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[-1, seq - 5:] = 0
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    return (ids, np.zeros_like(ids), mask), labels


def _world(n_workers, mesh_chips=None, state_dicts=None, seed=0):
    units = _units(bert_config, bert_layer_configs)
    wm = _pool(WorkerManager, n_workers, mesh_chips)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(seed))
    return wm, ps


def _params(model):
    return [p.detach() for s in model.stages for p in s.parameters]


def test_mesh_matches_mpmd_params_bitwise():
    """At one position per stage, the same allocation: the mesh engine's
    losses and parameters equal ``PipelineModel``'s bit for bit, GPipe
    steps then 1F1B steps."""
    data, labels = _batch()
    mpmd = PipelineModel(*_world(3), sgd(LR), cross_entropy_loss,
                         devices=CPUS, num_microbatches=4)
    mesh = MeshPipelineModel(*_world(3), sgd(LR), cross_entropy_loss,
                             devices=CPUS, num_microbatches=4)
    assert mesh.chips_per_stage == [1, 1, 1]
    for schedule in ("gpipe", "1f1b"):
        mpmd.schedule = mesh.schedule = schedule
        for i in range(2):
            assert mpmd.train_step(data, labels) == mesh.train_step(
                data, labels)
        assert all(torch.equal(a, b)
                   for a, b in zip(_params(mpmd), _params(mesh)))


def test_mesh_submesh_placement_and_two_positions_per_stage():
    """4 stages x 2 positions: each stage owns a contiguous block of the
    device list, its rows split over dp=2, a parameter copy on its
    second position kept equal to the first; two steps within 1e-6 of
    ``PipelineModel`` on the same allocation."""
    data, labels = _batch(1)
    model = MeshPipelineModel(*_world(4, mesh_chips=[2, 2, 2, 2]), sgd(LR),
                              cross_entropy_loss, devices=CPUS,
                              num_microbatches=2)
    mpmd = PipelineModel(*_world(4), sgd(LR), cross_entropy_loss,
                         devices=CPUS, num_microbatches=2)
    assert model.chips_per_stage == [2, 2, 2, 2]
    for i, stage in enumerate(model.stages):
        assert stage.mesh.shape == {"dp": 2, "tp": 1}
        assert stage.dp == 2 and stage.tp == 1
        assert stage.lane_name.startswith(f"stage {i} [cpux2 dp=2 tp=1]")
        assert len(stage._copies) == 1
    for _ in range(2):
        np.testing.assert_allclose(model.train_step(data, labels),
                                   mpmd.train_step(data, labels),
                                   rtol=1e-6)
    for a, b in zip(_params(model), _params(mpmd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for stage in model.stages:
        for copy, p in zip(stage._copies[0].parameters(), stage.parameters):
            assert torch.equal(copy, p) and copy is not p


@pytest.fixture(scope="module")
def jax_mesh_runs(devices):
    """JAX's mesh engine over 4 workers at 2 chips a stage (tp 1 and 2),
    two SGD steps each, from one set of weights."""
    units = _units(jax_bert_config, jax_bert_layers)
    data, labels = _batch(2)
    out = {}
    for tp in (1, 2):
        wm = _pool(JaxWorkerManager, 4, mesh_chips=[2, 2, 2, 2])
        JaxAllocator(units, wm, None, None).even_allocate()
        ps = JaxParameterServer(units, example_inputs=data,
                                rng=jax.random.key(5))
        init = params_from_jax(ps.params, units)
        model = JaxMeshPipeline(wm, ps, _OPT, jax_ce, devices=devices,
                                num_microbatches=2, tp=tp)
        losses = [model.train_step(data, labels, rng=jax.random.key(i))
                  for i in range(2)]
        model.sync_to_parameter_server()
        out[tp] = dict(init=init, losses=losses,
                       trained=params_from_jax(ps.params, units))
    return dict(data=data, labels=labels, runs=out)


@pytest.mark.parametrize("tp", [1, 2])
def test_two_positions_per_stage_match_jax(jax_mesh_runs, tp):
    run = jax_mesh_runs["runs"][tp]
    wm, ps = _world(4, mesh_chips=[2, 2, 2, 2], state_dicts=run["init"])
    model = MeshPipelineModel(wm, ps, sgd(LR), cross_entropy_loss,
                              devices=CPUS, num_microbatches=2, tp=tp)
    assert [(s.dp, s.tp) for s in model.stages] == [(2 // tp, tp)] * 4
    losses = [model.train_step(jax_mesh_runs["data"],
                               jax_mesh_runs["labels"]) for _ in range(2)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    model.sync_to_parameter_server()
    for got, ref in zip(ps.params, run["trained"]):
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


def _moe_units(pkg):
    cfg = pkg.GptConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=64, dropout_prob=0.0,
                        dtype="float32")
    return pkg.gpt_layer_configs(cfg, deterministic=True, moe_every=1,
                                 num_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def jax_moe_mesh_run(devices):
    """JAX's mesh engine on a mixture-of-experts GPT over 3 workers at 2
    chips a stage, two SGD steps: each stage is one program over its
    sub-mesh, so an MoE block routes the whole microbatch's tokens."""
    units = _moe_units(jgpt)
    ids = np.random.default_rng(6).integers(0, 256, (4, 16)).astype(np.int32)
    wm = _pool(JaxWorkerManager, 3, mesh_chips=[2, 2, 2])
    JaxAllocator(units, wm, None, None).even_allocate()
    ps = JaxParameterServer(units, example_inputs=(ids,),
                            rng=jax.random.key(7))
    init = params_from_jax(ps.params, units)
    model = JaxMeshPipeline(wm, ps, _OPT, jlosses.causal_lm_loss,
                            devices=devices, num_microbatches=2)
    losses = [model.train_step((ids,), ids, rng=jax.random.key(i))
              for i in range(2)]
    model.sync_to_parameter_server()
    return dict(ids=ids, init=init, losses=losses,
                trained=params_from_jax(ps.params, units))


def _moe_mesh_model(init, split_every_stage=False):
    units = _moe_units(tgpt)
    wm = _pool(WorkerManager, 3, mesh_chips=[2, 2, 2])
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, state_dicts=init)
    model = MeshPipelineModel(wm, ps, sgd(LR), causal_lm_loss,
                              devices=CPUS, num_microbatches=2)
    if split_every_stage:
        for stage in model.stages:
            stage.splits_rows = True
    return model, ps


def test_row_coupled_units_run_the_whole_microbatch(jax_moe_mesh_run):
    """At dp=2 a stage holding an MoE block runs its microbatch unsplit
    (its capacity and routing are over all the call's tokens), a stage
    without one splits its rows: losses and parameters within 1e-5 of
    JAX's mesh engine and of ``PipelineModel``.  Splitting the MoE
    stages' rows too routes other tokens and misses JAX's losses."""
    run = jax_moe_mesh_run
    ids = run["ids"]
    model, ps = _moe_mesh_model(run["init"])
    assert [s.splits_rows for s in model.stages] == [True, False, False]
    losses = [model.train_step((ids,), ids) for _ in range(2)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    model.sync_to_parameter_server()
    for got, ref in zip(ps.params, run["trained"]):
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    wm1 = _pool(WorkerManager, 3)
    Allocator(_moe_units(tgpt), wm1).even_allocate()
    mpmd = PipelineModel(wm1, ParameterServer(_moe_units(tgpt),
                                              state_dicts=run["init"]),
                         sgd(LR), causal_lm_loss, devices=CPUS,
                         num_microbatches=2)
    np.testing.assert_allclose(
        [mpmd.train_step((ids,), ids) for _ in range(2)], losses, rtol=1e-5)
    split, _ = _moe_mesh_model(run["init"], split_every_stage=True)
    split_loss = split.train_step((ids,), ids)
    assert abs(split_loss - run["losses"][0]) > 1e-4 * abs(run["losses"][0])


def test_mesh_rejects_indivisible_microbatch():
    """Microbatch rows that a stage's dp does not divide are refused
    before any work, naming the stage's dp."""
    data, labels = _batch(3, batch=6)
    model = MeshPipelineModel(*_world(2, mesh_chips=[2, 2]), sgd(LR),
                              cross_entropy_loss, devices=CPUS,
                              num_microbatches=2)
    with pytest.raises(ValueError, match="dp=2"):
        model.compute_gradients(data, labels)


def test_rebuild_reads_the_allocators_reshape():
    """``mesh_allocate`` on the live pool, then ``rebuild()``: the engine
    takes the new partition and chips and still trains."""
    units = _units(bert_config, bert_layer_configs)
    wm = _pool(WorkerManager, 4)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(0))
    model = MeshPipelineModel(wm, ps, sgd(LR), cross_entropy_loss,
                              devices=CPUS, num_microbatches=2)
    assert model.chips_per_stage == [1, 1, 1, 1]

    class _Dev:
        def benchmark(self):
            return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                    for w in wm.worker_pool}

    class _Mod:
        def benchmark(self):
            return [1.0] * len(units), [0.1] * len(units)

    Allocator(units, wm, _Mod(), _Dev()).mesh_allocate(
        num_devices=8, max_chips_per_stage=2, stage_overhead=0.5)
    model.rebuild()
    staged = sorted((w for w in wm.worker_pool if w.model_config),
                    key=lambda w: w.order)
    assert model.chips_per_stage == [w.extra_config["mesh_chips"]
                                     for w in staged]
    assert model.partition_signature() == [len(w.model_config)
                                           for w in staged]
    assert np.isfinite(model.train_step(*_batch(4)))
