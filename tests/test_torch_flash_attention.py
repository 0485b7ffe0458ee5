"""Flash attention (kernel B1) port contracts on the CPU: the plain
version and the port's ``flash_attention`` on CPU tensors against the
JAX package's Pallas ``flash_attention`` (interpret mode) on the same
numpy inputs, at the shapes and tolerances of
``tests/test_flash_attention.py`` — outputs rtol 2e-5 / atol 2e-6,
gradients rtol 5e-4 / atol 5e-6 — plus the padding invariance, an
indivisible length and the refusal of L = 1030; and the float32
tensor-core body's 3xTF32 arithmetic, emulated with torch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skycomputing_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from skycomputing_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

pytestmark = pytest.mark.torch_port

OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)

# name -> (B, L, H, D, masked tail keys, jax block_q/block_k)
CASES = {
    "default": (2, 128, 4, 32, 0, 32),
    "padded_tail": (2, 128, 4, 32, 32, 32),
    "indivisible_L100": (2, 100, 4, 32, 0, 64),
    "one_tile_bert_shape": (2, 128, 2, 64, 24, 256),
}


def _inputs(seed, B, L, H, D, masked_tail=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((B, L), np.float32)
    if masked_tail:
        bias[:, -masked_tail:] = -10000.0
    return q, k, v, bias


def _torch(*arrays, requires_grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(requires_grad)
            for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_and_port_match_jax(name):
    B, L, H, D, tail, block = CASES[name]
    q, k, v, bias = _inputs(sorted(CASES).index(name), B, L, H, D, tail)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        None, block, block))
    tq, tk, tv, tb = _torch(q, k, v, bias)
    before = flash_attention.launches
    port = flash_attention(tq, tk, tv, tb)
    plain = flash_attention_reference(tq, tk, tv, tb, D ** -0.5)
    assert flash_attention.launches == before  # CPU tensors: no kernel
    np.testing.assert_allclose(port.numpy(), ref, **OUT_TOL)
    np.testing.assert_allclose(plain.numpy(), ref, **OUT_TOL)


@pytest.mark.parametrize("D", [36, 37, 40])
def test_odd_head_dims_match_jax(D):
    """Head dims that are not a multiple of the card's mma k-step (the
    kernel stages them padded with zeros): the port's function and its
    plain version against the Pallas kernel at the same tolerance, with
    the JAX signature's default scale (the real ``D ** -0.5``) and a
    padded tail."""
    B, L, H, tail, block = 2, 128, 4, 24, 64
    q, k, v, bias = _inputs(60 + D, B, L, H, D, tail)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        None, block, block))
    tq, tk, tv, tb = _torch(q, k, v, bias)
    port = flash_attention(tq, tk, tv, tb)
    plain = flash_attention_reference(tq, tk, tv, tb, D ** -0.5)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(port.numpy(), ref, **OUT_TOL)
    np.testing.assert_allclose(plain.numpy(), ref, **OUT_TOL)


def test_masked_keys_do_not_influence_outputs():
    q, k, v, bias = _inputs(1, 2, 128, 4, 32, masked_tail=32)
    k2 = k.copy()
    k2[:, -32:] = np.random.default_rng(9).standard_normal(
        k2[:, -32:].shape).astype(np.float32)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    out = flash_attention(tq, tk, tv, tb)
    out2 = flash_attention(tq, torch.from_numpy(k2), tv, tb)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_all_padding_rows_stay_finite():
    """A row whose every key carries -1e4 is shifted, not masked: the
    bias is a term of the score, so its softmax is the unbiased one (up
    to float32's step of 1e-3 at 1e4, where the shifted scores round)
    and its output finite."""
    q, k, v, zero = _inputs(4, 1, 16, 2, 8)
    masked = np.full((1, 16), -10000.0, np.float32)
    out = flash_attention(*_torch(q, k, v, masked))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        out.numpy(), flash_attention(*_torch(q, k, v, zero)).numpy(),
        rtol=0, atol=2e-3)


def test_grads_match_jax():
    q, k, v, bias = _inputs(2, 1, 64, 2, 16)
    bias[:, -8:] = -10000.0

    def loss_jax(q, k, v, bias):
        return jnp.sum(jax_flash_attention(q, k, v, bias, None, 32, 32) ** 2)

    ref = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    tensors = _torch(q, k, v, bias, requires_grad=True)
    (flash_attention(*tensors) ** 2).sum().backward()
    for t, g in zip(tensors, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)


def test_bfloat16_matches_jax_bfloat16():
    """bf16 inputs, as on the main path: the output in bf16, within one
    bf16 rounding of JAX's."""
    q, k, v, bias = _inputs(5, 2, 64, 2, 32, masked_tail=8)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, bias)]
    ref = np.asarray(jax_flash_attention(*jargs, None, 32, 32), np.float32)
    targs = [t.to(torch.bfloat16) for t in _torch(q, k, v, bias)]
    out = flash_attention(*targs)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2)


def test_length_without_an_aligned_block_is_refused_like_jax():
    q, k, v, bias = _inputs(3, 1, 1030, 1, 8)
    with pytest.raises(ValueError, match="no 8-aligned divisor"):
        jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v, bias)))
    with pytest.raises(ValueError, match="no 8-aligned divisor"):
        flash_attention(*_torch(q, k, v, bias))


# --- the float32 tensor-core body's arithmetic (3xTF32), emulated ---------


def _tf32(x):
    """``x`` rounded to tf32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), kept as float32."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_3xtf32(a, b):
    """a @ b as the body takes each product: three tf32 products into
    one float32 sum, small terms first, small.small dropped."""
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _emulated(q, k, v, bias, scale, mm):
    """The body's function with its products taken by ``mm``: scores
    times scale plus the bias in float32, a float32 softmax, P.V."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) * scale + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (mm(p, vh) / p.sum(dim=-1, keepdim=True)).permute(0, 2, 1, 3)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2 * 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(_tf32(x), want)
    big, small = _split(x)
    assert torch.equal(big + small, x)  # these split exactly


@pytest.mark.parametrize("L", [128, 1024])
def test_3xtf32_products_keep_float32_accuracy(L):
    """3xTF32, as the float32 tensor-core body computes (4 heads of 64,
    a masked tail), lies within 1e-5 of the plain version, a tenth of
    the card's float32 tolerance (1e-4); single TF32 products lie more
    than 1e-4 off, which is why the body takes three."""
    q, k, v, bias = _torch(*_inputs(L, 2, L, 4, 64, masked_tail=L // 8))
    ref = flash_attention_reference(q, k, v, bias, 0.125)
    three = (_emulated(q, k, v, bias, 0.125, _mm_3xtf32) - ref).abs().max()
    one = (_emulated(q, k, v, bias, 0.125, _mm_tf32) - ref).abs().max()
    assert three <= 1e-5, three
    assert one > 1e-4 and one > 50 * three, (one, three)
