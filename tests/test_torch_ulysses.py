"""Ulysses attention in the port (``parallel/ulysses.py``) against the
JAX package's on the same numpy inputs (``tests/test_ulysses.py``'s
cases): JAX on its 8-device CPU mesh, the port on 8 CPU positions (and
on 2 and 4 against JAX's first 2 and 4 devices); outputs at rtol 2e-5 /
atol 2e-6, gradients at rtol 5e-4 / atol 5e-6; both ``ValueError``s
with JAX's messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from skycomputing_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses,
)
from skycomputing_tpu_torch.parallel.mesh import make_1d_mesh
from skycomputing_tpu_torch.parallel.ring_attention import (
    full_attention_reference,
    ring_attention,
)
from skycomputing_tpu_torch.parallel.ulysses import ulysses_attention

pytestmark = pytest.mark.torch_port

OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)


def _qkv(seed, B=2, L=64, H=8, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, L, H, D)).astype(np.float32)
                 for _ in range(3))


def _bias(B=2, L=64):
    bias = np.zeros((B, L), np.float32)
    bias[:, 48:] = -10000.0
    return bias


def _meshes(devices, S):
    return (JaxMesh(np.array(devices[:S]), axis_names=("sp",)),
            make_1d_mesh(S, "sp", [torch.device("cpu")] * S))


def _jax_out(jmesh, qkv, **kw):
    return np.asarray(jax.jit(lambda q, k, v: jax_ulysses(
        q, k, v, jmesh, **kw))(*qkv))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_ulysses_matches_jax(devices, S):
    qkv = _qkv(S)
    jmesh, tmesh = _meshes(devices, S)
    out = ulysses_attention(*map(torch.from_numpy, qkv), tmesh)
    np.testing.assert_allclose(out.numpy(), _jax_out(jmesh, qkv), **OUT_TOL)
    ref = full_attention_reference(*map(torch.from_numpy, qkv))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **OUT_TOL)


def test_ulysses_causal_and_bias(devices):
    qkv = _qkv(1)
    bias = _bias()
    jmesh, tmesh = _meshes(devices, 8)
    out = ulysses_attention(*map(torch.from_numpy, qkv), tmesh, causal=True,
                            bias=torch.from_numpy(bias))
    np.testing.assert_allclose(
        out.numpy(), _jax_out(jmesh, qkv, causal=True,
                              bias=jnp.asarray(bias)), **OUT_TOL)
    ref = full_attention_reference(*map(torch.from_numpy, qkv), causal=True,
                                   bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **OUT_TOL)


def test_ulysses_matches_ring():
    """Both sequence-parallel strategies agree with each other."""
    qkv = tuple(map(torch.from_numpy, _qkv(2)))
    mesh = make_1d_mesh(8, "sp", ["cpu"] * 8)
    np.testing.assert_allclose(ulysses_attention(*qkv, mesh).numpy(),
                               ring_attention(*qkv, mesh).numpy(), **OUT_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ulysses_grads_match(devices, causal):
    qkv = _qkv(3, B=1, L=32, H=8, D=8)
    bias = _bias(1, 32)
    jmesh, tmesh = _meshes(devices, 8)

    def loss(q, k, v):
        return jnp.sum(jax_ulysses(q, k, v, jmesh, causal=causal,
                                   bias=jnp.asarray(bias)) ** 2)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*qkv)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in qkv)
    out = ulysses_attention(qt, kt, vt, tmesh, causal=causal,
                            bias=torch.from_numpy(bias))
    got = torch.autograd.grad(out.pow(2).sum(), (qt, kt, vt))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


def test_ulysses_rejects_indivisible_heads(devices):
    qkv = _qkv(4, H=6)  # 6 heads over 8 positions
    jmesh, tmesh = _meshes(devices, 8)
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jax_ulysses(*qkv, jmesh)
    with pytest.raises(ValueError, match="divisible") as err:
        ulysses_attention(*map(torch.from_numpy, qkv), tmesh)
    assert str(err.value) == str(jax_err.value)


def test_ulysses_rejects_indivisible_sequence(devices):
    qkv = _qkv(5, L=60)  # 60 positions over 8
    jmesh, tmesh = _meshes(devices, 8)
    with pytest.raises(ValueError, match="sequence length") as jax_err:
        jax_ulysses(*qkv, jmesh)
    with pytest.raises(ValueError, match="sequence length") as err:
        ulysses_attention(*map(torch.from_numpy, qkv), tmesh)
    assert str(err.value) == str(jax_err.value)


def test_meta_run_moves_nothing():
    mesh = make_1d_mesh(4, "sp", ["cpu"] * 4)
    q = torch.empty(2, 64, 8, 16, device="meta")
    out = ulysses_attention(q, q, q, mesh, causal=True,
                            bias=torch.empty(2, 64, device="meta"))
    assert out.device.type == "meta" and out.shape == q.shape
