"""The arithmetic of the paged-attention kernel's tensor-core prefill
body (``paged_attention_kernel_mma`` in
``skycomputing_tpu_torch/ops/csrc/paged_attention.cu``), emulated in
plain PyTorch on the CPU and held against the port's plain version and
the JAX package's reference on the same numpy inputs.

The body runs only on the card (``tests/test_torch_cuda.py``); what
these tests pin is the order of its rounding, so that a tolerance seen
on the card has a reason here: q and K in bfloat16 (an int8 value,
|x| <= 127, is exact in bfloat16), each product summed in float32, the
float32 score times the softmax scale and, over int8 pages, times its
page's ``k_scale``; an online softmax in float32 over 64-position tiles;
each probability times its page's ``v_scale``, then split into a
bfloat16 head and the bfloat16 rounding of what the head leaves, each
multiplied by V (a single bfloat16 rounding of P moves an output by up
to 2^-9 of its size, which at |out| >= 4 rounds it to the neighbouring
bfloat16 value, 0.031 away); the output rounded to bfloat16.
"""

import numpy as np
import pytest
import torch

from skycomputing_tpu.ops.paged_attention import (
    paged_attention_reference as jax_paged_attention_reference,
)
from skycomputing_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
)

pytestmark = pytest.mark.torch_port

TILE = 64  # positions of one K/V tile of the body
BF16_TOL = 2e-2  # the card's tolerance for bfloat16 outputs


def split_bf16(x):
    """``x`` as (head, tail), both bfloat16 values held in float32:
    head = bf16(x), tail = bf16(x - head)."""
    head = x.to(torch.bfloat16).float()
    return head, (x - head).to(torch.bfloat16).float()


def tensor_core_body(q, k_pages, v_pages, page_table, index, k_scale=None,
                     v_scale=None, out_dtype=torch.bfloat16, split=True):
    """The tensor-core prefill body's arithmetic, one row and head at a
    time, on the CPU (``split=False``: P rounded to bf16 once, the
    design the body does not use; ``out_dtype`` float32: the output
    before its rounding)."""
    R, Lq, H, D = q.shape
    P, PS = k_pages.shape[:2]
    W = page_table.shape[1]
    scale = D ** -0.5
    out = torch.empty(R, Lq, H, D, dtype=out_dtype)
    for r in range(R):
        idx = int(index[r])
        n_pos = min(W * PS, idx + Lq)
        pos = torch.arange(n_pos)
        phys = page_table[r].long().clamp(0, P - 1)[pos // PS]
        qpos = idx + torch.arange(Lq)
        for h in range(H):
            qh = q[r, :, h].to(torch.bfloat16).float()
            k = k_pages[phys, pos % PS, h].float().to(torch.bfloat16).float()
            v = v_pages[phys, pos % PS, h].float().to(torch.bfloat16).float()
            ks = (k_scale[phys, h] if k_scale is not None
                  else torch.ones(n_pos))
            vs = (v_scale[phys, h] if v_scale is not None
                  else torch.ones(n_pos))
            m = torch.full((Lq,), float("-inf"))
            l = torch.zeros(Lq)
            acc = torch.zeros(Lq, D)
            for k0 in range(0, n_pos, TILE):
                cols = slice(k0, min(k0 + TILE, n_pos))
                x = (qh @ k[cols].T) * scale * ks[cols]
                x = x.masked_fill(pos[cols][None] > qpos[:, None],
                                  float("-inf"))
                m_new = torch.maximum(m, x.max(dim=1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(x - m_new[:, None])
                l = l * corr + p.sum(dim=1)
                parts = (split_bf16(p * vs[cols]) if split else
                         (split_bf16(p * vs[cols])[0],))
                pv = sum(part @ v[cols] for part in parts)
                acc = acc * corr[:, None] + pv
                m = m_new
            out[r, :, h] = (acc / l.clamp_min(1e-30)[:, None]).to(
                out_dtype)
    return out


def _wave(Lq, D, int8, seed, H=12, PS=16):
    """A prefill wave as the serving engine launches it: 2 live rows (one
    fresh, one appending after a 64-token prefix) and 2 all-sentinel pad
    rows, over a 64-page pool; int8 pages are N(0, 32) rounded and
    clipped, with per-(page, head) scales U(0.02, 0.04)."""
    P = 64
    W = (64 + Lq + PS - 1) // PS
    rng = np.random.default_rng(seed)
    pages = rng.permutation(P - 1)
    table = np.full((4, W), P, np.int32)
    index = np.array([0, 64, 0, 0], np.int32)
    used = 0
    for r in range(2):
        n = (int(index[r]) + Lq + PS - 1) // PS
        table[r, :n] = pages[used:used + n]
        used += n
    q = rng.standard_normal((4, Lq, H, D)).astype(np.float32)
    if int8:
        k, v = (np.clip(np.round(32 * rng.standard_normal((P, PS, H, D))),
                        -127, 127).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.02, 0.04, (P, H)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.standard_normal((P, PS, H, D)).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    return q, k, v, ks, vs, table, index


def _torch_args(q, k, v, ks, vs, table, index):
    t = torch.from_numpy
    bf16 = (lambda a: t(a).to(torch.bfloat16)) if ks is None else t
    kw = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
    return (t(q).to(torch.bfloat16), bf16(k), bf16(v), t(table),
            t(index)), kw


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages",
                                                     "int8_pages"])
def test_body_arithmetic_matches_plain_version_and_jax_at_gpt2_heads(int8):
    """GPT-2 small's heads (H=12, D=64), page 16, Lq=128: the emulated
    body within the card's bf16 tolerance of the plain version on every
    row (pad rows included), and of the JAX package's reference on the
    live rows (its reference clips sentinels otherwise)."""
    arrays = _wave(128, 64, int8, seed=6)
    args, kw = _torch_args(*arrays)
    got = tensor_core_body(*args, **kw).float()
    ref = paged_attention_reference(*args, **kw).float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= BF16_TOL
    q, k, v, ks, vs, table, index = arrays
    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    jax_ref = np.asarray(jax_paged_attention_reference(
        np.asarray(args[0].float()), np.asarray(args[1].float()),
        np.asarray(args[2].float()), table, index, **scales),
        dtype=np.float32)
    live = slice(0, 2)
    assert np.abs(got[live].numpy() - jax_ref[live]).max() <= BF16_TOL


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Lq", [17, 63, 64, 65, 256])
def test_body_arithmetic_matches_plain_version_at_its_edges(Lq, D):
    """One and four warps' worth of queries, one past a tile, the
    largest bucket, at head_dim 64 and 128, over bf16 and int8 pages."""
    for int8 in (False, True):
        args, kw = _torch_args(*_wave(Lq, D, int8, seed=Lq + D, H=2))
        got = tensor_core_body(*args, **kw).float()
        ref = paged_attention_reference(*args, **kw).float()
        assert (got - ref).abs().max().item() <= BF16_TOL, (Lq, D, int8)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages",
                                                     "int8_pages"])
def test_split_p_holds_the_float32_result(int8):
    """Before the output is rounded, P split into a bf16 head and tail
    keeps the body within 1e-4 of the plain version's float32 result
    (GPT-2 small's prefill shape); one bf16 rounding of P does not: its
    error is a sizeable part of a bf16 step at |out| >= 2, where one
    step is 0.0156 and more."""
    args, kw = _torch_args(*_wave(128, 64, int8, seed=6))
    q = args[0].float()  # bf16 values: the plain version's output in f32
    ref = paged_attention_reference(q, *args[1:], **kw)
    split = tensor_core_body(q, *args[1:], **kw, out_dtype=torch.float32)
    single = tensor_core_body(q, *args[1:], **kw, out_dtype=torch.float32,
                              split=False)
    assert (split - ref).abs().max().item() <= 1e-4
    assert (single - ref).abs().max().item() >= 1e-3


def test_int8_scale_folding_equals_dequantizing_first():
    """In exact arithmetic (float64 here) scaling the score by k_scale
    after q.k, and P by v_scale before P.V, is the Pallas kernel's
    dequantize-then-multiply: a scale is constant along the head dim that
    each product sums over."""
    q, k, v, ks, vs, table, index = _wave(128, 64, True, seed=11, H=2)
    phys = np.clip(table[1], 0, 63)
    kq = k[phys].reshape(-1, 2, 64).astype(np.float64)
    vq = v[phys].reshape(-1, 2, 64).astype(np.float64)
    ksc = np.repeat(ks[phys], 16, axis=0).astype(np.float64)
    vsc = np.repeat(vs[phys], 16, axis=0).astype(np.float64)
    qd = q[1].astype(np.float64)
    first = np.einsum("qhd,khd->hqk", qd, kq * ksc[..., None])
    folded = np.einsum("qhd,khd->hqk", qd, kq) * ksc.T[:, None, :]
    np.testing.assert_allclose(folded, first, rtol=1e-12, atol=1e-12)
    p = np.random.default_rng(0).random(first.shape)
    np.testing.assert_allclose(
        np.einsum("hqk,khd->qhd", p * vsc.T[:, None, :], vq),
        np.einsum("hqk,khd->qhd", p, vq * vsc[..., None]),
        rtol=1e-12, atol=1e-12)
