"""Ring attention in the port (``parallel/ring_attention.py``) against
the JAX package's on the same numpy inputs: JAX on its 8-device CPU
mesh (the first S devices), the port on a mesh of S CPU positions.
Outputs at rtol 2e-5 / atol 2e-6 and gradients at rtol 5e-4 / atol
5e-6 (``tests/test_ring_attention.py``'s tolerances), for S = 2, 4 and
8, causal and not, with and without a per-key bias; L=256 over 8
blocks; a shape-only run on ``meta``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from skycomputing_tpu.parallel.ring_attention import (
    full_attention_reference as jax_full,
)
from skycomputing_tpu.parallel.ring_attention import (
    ring_attention as jax_ring,
)
from skycomputing_tpu_torch.parallel.mesh import Mesh, make_1d_mesh
from skycomputing_tpu_torch.parallel.ring_attention import (
    full_attention_reference,
    ring_attention,
)

pytestmark = pytest.mark.torch_port

OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)


def _qkv(seed, B=2, L=64, H=4, D=16, bias=False):
    rng = np.random.default_rng(seed)
    qkv = tuple(rng.standard_normal((B, L, H, D)).astype(np.float32)
                for _ in range(3))
    b = None
    if bias:
        b = np.zeros((B, L), np.float32)
        b[:, (3 * L) // 4:] = -10000.0  # a padded tail
        b[0, : L // 8] += rng.standard_normal(L // 8).astype(np.float32)
    return qkv, b


def _meshes(devices, S):
    return (JaxMesh(np.array(devices[:S]), axis_names=("sp",)),
            make_1d_mesh(S, "sp", [torch.device("cpu")] * S))


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_ring_matches_jax(devices, S, causal, bias):
    (q, k, v), b = _qkv(10 * S + causal, bias=bias)
    jmesh, tmesh = _meshes(devices, S)
    ref = np.asarray(jax.jit(lambda q, k, v: jax_ring(
        q, k, v, jmesh, causal=causal, bias=_j(b)))(q, k, v))
    out = ring_attention(*map(torch.from_numpy, (q, k, v)), tmesh,
                         causal=causal, bias=_t(b))
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)
    dense = full_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal, bias=_t(b))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **OUT_TOL)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_ring_grads_match_jax(devices, S, causal, bias):
    (q, k, v), b = _qkv(100 + S, B=1, L=32, H=2, D=8, bias=bias)
    jmesh, tmesh = _meshes(devices, S)

    def loss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, jmesh, causal=causal,
                                bias=_j(b)) ** 2)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = ring_attention(qt, kt, vt, tmesh, causal=causal, bias=_t(b))
    got = torch.autograd.grad(out.pow(2).sum(), (qt, kt, vt))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


def test_long_sequence_many_blocks(devices):
    """L=256 over 8 positions: 32-token blocks, 8 ring steps, causal;
    the early queries see most key blocks fully masked."""
    (q, k, v), _ = _qkv(4, B=1, L=256, H=2, D=8)
    jmesh, tmesh = _meshes(devices, 8)
    ref = np.asarray(jax.jit(lambda q, k, v: jax_ring(
        q, k, v, jmesh, causal=True))(q, k, v))
    out = ring_attention(*map(torch.from_numpy, (q, k, v)), tmesh,
                         causal=True)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_full(*map(jnp.asarray, (q, k, v)),
                                         causal=True)), **OUT_TOL)


def test_bfloat16_inputs_return_bfloat16():
    (q, k, v), b = _qkv(5, bias=True)
    mesh = make_1d_mesh(4, "sp", ["cpu"] * 4)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = ring_attention(qb, kb, vb, mesh, bias=_t(b))
    ref = full_attention_reference(qb, kb, vb, bias=_t(b))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_meta_run_moves_nothing():
    """On ``meta`` every position is ``meta``: the shapes come back and
    the mesh's devices are never touched."""
    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ["sp"])
    q = torch.empty(2, 64, 4, 16, device="meta")
    bias = torch.empty(2, 64, device="meta")
    out = ring_attention(q, q, q, mesh, causal=True, bias=bias)
    assert out.device.type == "meta" and out.shape == q.shape


def test_indivisible_sequence_and_wrong_axis_raise():
    mesh = make_1d_mesh(4, "sp", ["cpu"] * 4)
    q = torch.zeros(1, 30, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, q, q, mesh)
    with pytest.raises(ValueError, match="1-d mesh over 'tp'"):
        ring_attention(torch.zeros(1, 32, 2, 8), q, q, mesh, axis_name="tp")
