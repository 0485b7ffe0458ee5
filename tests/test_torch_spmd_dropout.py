"""Dropout in the port's compiled engines (``deterministic=False``):
with every dropout rate 0 the stochastic engine equals the deterministic
one (also on a dp x pp x tp mesh, against the plain engine on the same
full weights, within 1e-5); at rate 0.1 a seed reproduces its loss and
another seed changes it, through GPipe, the interleaved schedule, dp x
tp and GPT; the trajectory departs from the deterministic one and still
trains; under tp the masks on replicated activations are equal across
tp (the copies stay equal) and the attention-probs masks differ; a
stochastic engine without ``rng=`` and a deterministic one given it
raise.  JAX's threefry masks are not reproduced: these are the
contracts of ``tests/test_spmd_dropout.py``."""

import numpy as np
import pytest
import torch

from skycomputing_tpu_torch.parallel import (
    CompiledBertPipeline,
    CompiledGptPipeline,
    make_dp_pp_mesh,
    make_dp_pp_tp_mesh,
    make_pipeline_mesh,
    spmd,
)
from skycomputing_tpu_torch.parallel.spmd import split_stage_params_for_tp
from test_torch_spmd_helpers import (
    CPUS,
    TOL,
    bert_cfgs,
    bert_data,
    gpt_cfgs,
    gpt_data,
    one_torch_thread,  # noqa: F401 - an autouse fixture
)

pytestmark = pytest.mark.torch_port


def _bert(dropout, mesh, **kw):
    _, cfg = bert_cfgs(dropout)
    kw.setdefault("units_per_stage", 2)
    return CompiledBertPipeline(cfg, mesh, **kw)


def test_rate0_matches_deterministic_engine():
    mesh = make_pipeline_mesh(4, CPUS)
    batch, labels = bert_data()
    det = _bert(0.0, mesh, num_microbatches=4)
    sto = _bert(0.0, mesh, num_microbatches=4, deterministic=False)
    params = det.init(0)
    with torch.no_grad():
        l_det = float(det.loss(params, batch, labels))
        l_sto = float(sto.loss(params, batch, labels, rng=7))
    np.testing.assert_allclose(l_det, l_sto, rtol=1e-6)


@pytest.mark.parametrize("layout", ["gpipe", "interleaved", "dp_tp"])
def test_seeded_determinism_and_divergence(layout):
    batch, labels = bert_data()
    if layout == "gpipe":
        pipe = _bert(0.1, make_pipeline_mesh(4, CPUS), num_microbatches=4,
                     deterministic=False)
    elif layout == "interleaved":
        pipe = _bert(0.1, make_pipeline_mesh(2, CPUS), units_per_stage=1,
                     num_microbatches=2, virtual_stages=2,
                     deterministic=False)
    else:
        pipe = _bert(0.1, make_dp_pp_tp_mesh(2, 2, 2, CPUS),
                     num_microbatches=2, deterministic=False)
    params = pipe.init(0)
    with torch.no_grad():
        a, b, c = (float(pipe.loss(params, batch, labels, rng=r))
                   for r in (3, 3, 4))
    assert np.isfinite(a)
    assert a == b, "same seed must reproduce the same masks"
    assert a != c, "different seeds must draw different masks"


def test_dropout_trajectory_diverges_but_trains():
    mesh = make_pipeline_mesh(4, CPUS)
    batch, labels = bert_data()
    det = _bert(0.0, mesh, num_microbatches=4, learning_rate=5e-2)
    sto = _bert(0.1, mesh, num_microbatches=4, learning_rate=5e-2,
                deterministic=False)
    p_det, p_sto = det.init(0), sto.init(0)
    o_det, o_sto = det.init_opt_state(p_det), sto.init_opt_state(p_sto)
    det_losses, sto_losses = [], []
    for i in range(5):
        p_det, o_det, l1 = det.train_step(p_det, o_det, batch, labels)
        p_sto, o_sto, l2 = sto.train_step(p_sto, o_sto, batch, labels,
                                          rng=11 + i)
        det_losses.append(float(l1))
        sto_losses.append(float(l2))
    assert np.isfinite(sto_losses).all()
    assert sto_losses != det_losses
    assert sto_losses[-1] < sto_losses[0], sto_losses


def test_rate0_tp_matches_plain_deterministic():
    """The tp dropout plumbing at rate 0 leaves the math alone."""
    batch, labels = bert_data()
    plain = _bert(0.0, make_dp_pp_mesh(2, 2, CPUS), num_microbatches=2)
    tp = _bert(0.0, make_dp_pp_tp_mesh(2, 2, 2, CPUS), num_microbatches=2,
               deterministic=False)
    tree = plain.gather(plain.init(0))
    params = plain.place(tree)
    params_tp = tp.place(dict(tree, stages=split_stage_params_for_tp(
        tree["stages"], 2)))
    with torch.no_grad():
        np.testing.assert_allclose(
            float(plain.loss(params, batch, labels)),
            float(tp.loss(params_tp, batch, labels, rng=1)), rtol=0,
            atol=TOL)


def test_tp_mask_discipline(monkeypatch):
    """Under tp: one seed for every tp copy of a replicated activation's
    mask (the copies stay equal), a seed per tp position for the
    head-sharded attention probabilities."""
    pipe = _bert(0.1, make_dp_pp_tp_mesh(1, 2, 2, CPUS),
                 num_microbatches=2, deterministic=False)
    params = pipe.init(0)
    seeds = []
    real = spmd.dropout

    def record(x, rate, seed):
        seeds.append((x.dim(), seed))
        return real(x, rate, seed)

    monkeypatch.setattr(spmd, "dropout", record)
    hidden = torch.randn(2, 16, 128)
    mask = torch.zeros(2, 1, 1, 16)
    local = [pipe._chunk_params(params["stages"], pipe.position(0, 0, t), 0,
                                None) for t in range(2)]
    with torch.no_grad():
        out, _ = pipe.tp_stage.apply(local, [hidden, hidden], [mask, mask],
                                     [torch.device("cpu")] * 2, seed=99)
    assert torch.equal(out[0], out[1])
    probs = [s for d, s in seeds if d == 4]
    replicated = [s for d, s in seeds if d == 3]
    assert len(probs) == 2 * 2  # units x tp
    assert len(replicated) == 2 * 2 * 2  # units x sites x tp
    for u in range(2):
        assert probs[2 * u] != probs[2 * u + 1]
    assert all(replicated[i] == replicated[i + 1]
               for i in range(0, len(replicated), 2))


def test_gpt_dropout_rate0_and_seeded():
    ids, labels = gpt_data()
    mesh = make_pipeline_mesh(2, CPUS)
    _, cfg0 = gpt_cfgs(0.0)
    det = CompiledGptPipeline(cfg0, mesh, units_per_stage=2,
                              num_microbatches=2)
    sto = CompiledGptPipeline(cfg0, mesh, units_per_stage=2,
                              num_microbatches=2, deterministic=False)
    params = det.init(0)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(det.loss(params, (ids,), labels)),
            float(sto.loss(params, (ids,), labels, rng=1)), rtol=1e-6)
    _, cfg1 = gpt_cfgs(0.1)
    sto1 = CompiledGptPipeline(cfg1, mesh, units_per_stage=2,
                               num_microbatches=2, deterministic=False)
    p1 = sto1.init(0)
    with torch.no_grad():
        a, b, c = (float(sto1.loss(p1, (ids,), labels, rng=r))
                   for r in (2, 2, 3))
    assert a == b and a != c


def test_rng_guards():
    mesh = make_pipeline_mesh(2, CPUS)
    batch, labels = bert_data()
    sto = _bert(0.1, mesh, units_per_stage=1, num_microbatches=2,
                deterministic=False)
    params = sto.init(0)
    with pytest.raises(ValueError, match="deterministic=False"):
        sto.loss(params, batch, labels)
    det = _bert(0.0, mesh, units_per_stage=1, num_microbatches=2)
    p = det.init(0)
    with pytest.raises(ValueError, match="deterministic"):
        det.train_step(p, det.init_opt_state(p), batch, labels, rng=0)
