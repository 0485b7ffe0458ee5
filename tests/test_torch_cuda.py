"""The port's CUDA kernels (paged attention over fp and int8 pools)
against their plain PyTorch versions, on the card.  Every test here is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false:
a hand-written kernel has no CPU mode.  The file imports neither jax
nor the JAX package, so it runs on a machine that has only PyTorch::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from skycomputing_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

# 1e-4 in float32 (another summation order than the plain version), 2e-2
# in bfloat16 (the output is rounded to bfloat16)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (num_pages, page_size, heads, head_dim, Lq, [(table row, index)])
SHAPES = {
    # decode: a page-boundary crossing, a short row, an inactive row
    "decode": (10, 4, 2, 16, 1,
               [([7, 2, 5], 8), ([0, 9], 4), ([], 0), ([1, 3, 4, 6, 8], 16)]),
    # prefill longer than one 16-query tile, with a pad row
    "prefill_two_tiles": (12, 8, 2, 32, 24,
                          [([3, 1, 7, 9], 0), ([5, 2, 0, 11, 6], 8),
                           ([], 0)]),
    # head_dim 128 x page_size 64: over 48 KB of shared memory
    "wide_pages": (6, 64, 2, 128, 3,
                   [([4, 1], 70), ([2], 0)]),
    # speculative verify (Lq = k + 1 = 5), first queries mid-page
    "verify": (10, 4, 2, 16, 5,
               [([7, 2, 5], 6), ([0, 9], 2), ([], 0), ([1, 3, 4, 6, 8], 13)]),
}


def _case(name, dtype):
    P, PS, H, D, Lq, rows = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    width = max(len(t) for t, _ in rows)
    table = np.full((len(rows), width), P, np.int32)
    index = np.zeros(len(rows), np.int32)
    for r, (pages, idx) in enumerate(rows):
        table[r, : len(pages)] = pages
        index[r] = idx
    dt = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to("cuda", dt)

    return (draw(len(rows), Lq, H, D), draw(P, PS, H, D), draw(P, PS, H, D),
            torch.from_numpy(table).cuda(), torch.from_numpy(index).cuda())


def _int8_case(name, dtype):
    """The same rows over an int8 pool: values ~ N(0, 32) rounded and
    clipped to [-127, 127], scales ~ U(0.02, 0.04) per (page, head), so
    the dequantized pages are of unit size."""
    q, _, _, table, index = _case(name, dtype)
    P, PS, H, D, _, _ = SHAPES[name]
    rng = np.random.default_rng(100 + sorted(SHAPES).index(name))

    def pages():
        vals = np.clip(np.round(32 * rng.standard_normal((P, PS, H, D))),
                       -127, 127).astype(np.int8)
        return torch.from_numpy(vals).cuda()

    def scales():
        return torch.from_numpy(
            rng.uniform(0.02, 0.04, (P, H)).astype(np.float32)).cuda()

    return q, pages(), pages(), scales(), scales(), table, index


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_paged_attention_kernel_matches_plain_version(card, name, dtype):
    args = _case(name, dtype)
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(*args)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"max |err| {err}"


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_paged_attention_int8_kernel_matches_plain_version(card, name, dtype):
    q, k, v, ks, vs, table, index = _int8_case(name, dtype)
    before = (paged_attention.launches, paged_attention_int8.launches)
    out = paged_attention(q, k, v, table, index, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (paged_attention.launches,
            paged_attention_int8.launches) == (before[0], before[1] + 1)
    ref = paged_attention_reference(q, k, v, table, index, k_scale=ks,
                                    v_scale=vs)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"max |err| {err}"


def test_paged_attention_int8_rejects_what_the_kernel_does_not_take(card):
    q, k, v, ks, vs, table, index = _int8_case("verify", "float32")
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, k, v, table, index, k_scale=ks)
    with pytest.raises(ValueError, match="k_scale shape"):
        paged_attention(q, k, v, table, index, k_scale=ks[:, :1].clone(),
                        v_scale=vs)
    with pytest.raises(ValueError, match="k_pages"):
        paged_attention(q, k.float(), v, table, index, k_scale=ks,
                        v_scale=vs)
    with pytest.raises(ValueError, match="v_scale"):
        paged_attention(q, k, v, table, index, k_scale=ks,
                        v_scale=vs.double())


def test_paged_attention_rejects_what_the_kernel_does_not_take(card):
    q, k, v, table, index = _case("prefill_two_tiles", "float32")
    with pytest.raises(TypeError):
        paged_attention(q.half(), k.half(), v.half(), table, index)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                        k, v, table, index)
    with pytest.raises(ValueError, match="k_pages"):
        paged_attention(q, k.double(), v, table, index)
