"""The port's CUDA kernels (paged attention over fp and int8 pools,
flash attention) against their plain PyTorch versions, on the card, at
the main path's shapes and at the edges of each kernel body (which body
serves a case is asserted beside it).  Every test here is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false:
a hand-written kernel has no CPU mode.  The file imports neither jax
nor the JAX package, so it runs on a machine that has only PyTorch::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from skycomputing_tpu_torch.ops.flash_attention import (
    BF16_LONG_TOL,
    agreement,
    flash_attention,
    flash_attention_reference,
)
from skycomputing_tpu_torch.ops.flash_attention import (
    kernel_plan as flash_kernel_plan,
)
from skycomputing_tpu_torch.ops.paged_attention import (
    kernel_plan as paged_kernel_plan,
)
from skycomputing_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
    row_plan,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

# 1e-4 in float32 (another summation order than the plain version), 2e-2
# in bfloat16 (the output is rounded to bfloat16)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
F32_EXACT = torch.float64  # flash attention's float32 plain version, exactly

# (num_pages, page_size, heads, head_dim, Lq, [(table row, index)])
SHAPES = {
    # decode: a page-boundary crossing, a short row, an inactive row
    "decode": (10, 4, 2, 16, 1,
               [([7, 2, 5], 8), ([0, 9], 4), ([], 0), ([1, 3, 4, 6, 8], 16)]),
    # prefill longer than one 16-query tile, with a pad row (page size
    # 8: the register-tile body in both dtypes)
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


def _edge_rows(Lq):
    """A row at index 0 (its first query sees one position), a row whose
    last query fills all four of its pages, a row mid-page, an inactive
    row."""
    return [([3, 4], 0), ([5, 1, 7, 9], 64 - Lq), ([2, 0, 11], 20), ([], 0)]


# page_size 16 (the engine's) at the bodies' edges: Lq 1, 5 and 16 take
# the decode body, 17 the tensor-core body in bfloat16 and the
# register-tile body in float32
EDGE_SHAPES = {
    f"ps16_d{D}_lq{Lq}": (12, 16, 2, D, Lq, _edge_rows(Lq))
    for D in (64, 128) for Lq in (1, 5, 16, 17)
}


def _prefill_rows(Lq, PS=16):
    """Over a table of W pages of PS: a row at index 0, a row whose last
    query fills the whole table, a row at index 20 (mid-page) and an
    all-sentinel pad row; pages drawn from a pool of 3 W + 2."""
    W = (Lq + 63) // PS + 1
    need = lambda idx: (idx + Lq + PS - 1) // PS  # noqa: E731
    pages = iter(np.random.default_rng(Lq).permutation(3 * W + 1).tolist())
    return 3 * W + 2, [
        ([next(pages) for _ in range(need(0))], 0),
        ([next(pages) for _ in range(W)], PS * W - Lq),
        ([next(pages) for _ in range(need(20))], 20),
        ([], 0),
    ]


# the tensor-core prefill body's edges (bfloat16; float32 takes the
# register-tile body): Lq around one and four 16-row warps, the largest
# prefill bucket, head_dim 64 and 128
PREFILL_SHAPES = {
    f"prefill_d{D}_lq{Lq}": (_prefill_rows(Lq)[0], 16, 2, D, Lq,
                             _prefill_rows(Lq)[1])
    for D in (64, 128) for Lq in (17, 63, 64, 65, 256)
}
# the register-tile body's edges beyond PREFILL_SHAPES (which float32
# takes to it too): pages of 4 and 8 (bf16 q as well: the tensor-core body
# takes pages of 16 only), Lq one past the 16-query decode bound, one past
# a 32-query tile and two whole tiles, head_dim 40 (an int8 row of 40
# bytes, staged padded to 48), 64 and 128 (16-query tiles)
TILE_SHAPES = {
    f"tile_ps{PS}_d{D}_lq{Lq}": (_prefill_rows(Lq, PS)[0], PS, 2, D, Lq,
                                 _prefill_rows(Lq, PS)[1])
    for PS in (4, 8) for D in (40, 64, 128) for Lq in (17, 33, 64)
}
# K/V rows that are not whole 16-byte chunks, staged padded by the decode
# (Lq 1, 8, 16) and register-tile (Lq 17, 128) bodies over pages of 4, 8
# and 16, in every copy granule: head_dim 30 (float32 rows of 120 bytes
# copied 8 at a time, bf16 60 by 4, int8 30 by 2), 36 (144 by 16, 72 by
# 8, 36 by 4) and 37 (148 by 4, 74 by 2, 37 by 1)
ODD_SHAPES = {
    f"odd_ps{PS}_d{D}_lq{Lq}": (_prefill_rows(Lq, PS)[0], PS, 2, D, Lq,
                                _prefill_rows(Lq, PS)[1])
    for PS in (4, 8, 16) for D in (30, 36, 37) for Lq in (1, 8, 16, 17, 128)
}
ALL_SHAPES = {**SHAPES, **EDGE_SHAPES, **PREFILL_SHAPES, **TILE_SHAPES,
              **ODD_SHAPES}


def _seed(name):
    if name in SHAPES:
        return sorted(SHAPES).index(name)
    if name in EDGE_SHAPES:
        return 50 + sorted(EDGE_SHAPES).index(name)
    if name in PREFILL_SHAPES:
        return 150 + sorted(PREFILL_SHAPES).index(name)
    if name in TILE_SHAPES:
        return 350 + sorted(TILE_SHAPES).index(name)
    return 1000 + sorted(ODD_SHAPES).index(name)


def _case(name, dtype):
    P, PS, H, D, Lq, rows = ALL_SHAPES[name]
    rng = np.random.default_rng(_seed(name))
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
    P, PS, H, D, _, _ = ALL_SHAPES[name]
    rng = np.random.default_rng(100 + _seed(name))

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


def _paged_body(q, pages):
    """The body :func:`paged_kernel_plan` names for ``q`` over ``pages``,
    checked against the rule it states, and the row plan's granule
    against the row's bytes."""
    Lq, D = q.shape[1], q.shape[3]
    body = paged_kernel_plan(q.dtype, pages.dtype, Lq, D, pages.shape[1])
    if Lq <= 16:
        assert body == "decode"
    elif (q.dtype == torch.bfloat16 and D % 16 == 0
          and pages.shape[1] % 16 == 0):
        assert body == "tensor_core"
    else:
        assert body == "register_tile"
    row = D * pages.element_size()
    assert row % row_plan(pages.dtype, D)["copy_bytes"] == 0
    return body


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(ALL_SHAPES))
def test_paged_attention_kernel_matches_plain_version(card, name, dtype):
    args = _case(name, dtype)
    body = _paged_body(args[0], args[1])
    before = paged_attention.launches
    body_before = paged_attention.body_launches[body]
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert paged_attention.body_launches[body] == body_before + 1
    ref = paged_attention_reference(*args)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"max |err| {err}"


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(ALL_SHAPES))
def test_paged_attention_int8_kernel_matches_plain_version(card, name, dtype):
    q, k, v, ks, vs, table, index = _int8_case(name, dtype)
    body = _paged_body(q, k)
    before = (paged_attention.launches, paged_attention_int8.launches)
    body_before = paged_attention_int8.body_launches[body]
    out = paged_attention(q, k, v, table, index, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (paged_attention.launches,
            paged_attention_int8.launches) == (before[0], before[1] + 1)
    assert paged_attention_int8.body_launches[body] == body_before + 1
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


# flash attention at the trainer's shapes and at the tensor-core bodies'
# edges: (B, L, H, D, padded tail keys)
FLASH_SHAPES = {
    "bert_large_L128": (8, 128, 16, 64, 32),  # one microbatch, BERT-large
    "bert_large_L128_B4": (4, 128, 16, 64, 32),  # a dp shard (2 warps)
    "long_L512": (2, 512, 16, 64, 0),  # several key tiles
    "indivisible_L100": (2, 100, 16, 64, 0),  # a ragged last tile
    "short_L7": (2, 7, 4, 64, 0),  # less than one mma tile
    "one_tile_L64": (2, 64, 4, 64, 0),  # exactly one 64-key tile
    "one_past_L65": (2, 65, 4, 64, 0),  # one key past the first tile
    "head_dim_32": (2, 96, 4, 32, 8),
    "head_dim_128": (2, 130, 4, 128, 8),
    "batch_1": (1, 128, 16, 64, 32),
    "all_keys_masked": (2, 64, 4, 64, 64),  # every key of every row masked
    # head_dims staged padded (bf16 to a multiple of 16, float32 of 8),
    # rows copied (bf16 / float32 bytes at a time): 40 at 48 / 40 (16 /
    # 16), 36 at 48 / 40 (8 / 16), 37 at 48 / 40 (2 / 4), 100 at 112 /
    # 104 (8 / 16), 120 at 128 / 120 (16 / 16)
    "head_dim_40": (2, 100, 4, 40, 8),
    "head_dim_36": (2, 100, 4, 36, 8),
    "head_dim_37": (2, 100, 4, 37, 8),
    "head_dim_100": (2, 100, 4, 100, 8),
    "head_dim_120": (2, 100, 4, 120, 8),
}
_FLASH_ORIGINAL = ("bert_large_L128", "indivisible_L100", "long_L512")
_FLASH_LATER = ("bert_large_L128_B4", "head_dim_36", "head_dim_37",
                "head_dim_100", "head_dim_120")


def _flash_case(name, dtype):
    B, L, H, D, tail = FLASH_SHAPES[name]
    earlier = sorted(n for n in FLASH_SHAPES if n not in _FLASH_LATER)
    seed = (200 + _FLASH_ORIGINAL.index(name) if name in _FLASH_ORIGINAL
            else 300 + _FLASH_LATER.index(name) if name in _FLASH_LATER
            else 250 + earlier.index(name))
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D))
                                .astype(np.float32)).to("cuda", dt)
               for _ in range(3))
    bias = torch.zeros(B, L)
    if tail:
        bias[:, -tail:] = -10000.0
    return q, k, v, bias.to("cuda", dt)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(FLASH_SHAPES))
def test_flash_attention_kernel_matches_plain_version(card, name, dtype):
    """Each case on the body its plan names, counted under that body, and
    within TOL of the plain version; in float32 of the plain version
    evaluated in float64, the function exactly (in ``all_keys_masked``
    the float32 plain version's own scores round to a step of 2^-10 at
    -1e4, which moves its output by up to about 4e-4)."""
    q, k, v, bias = _flash_case(name, dtype)
    B, L, H, D = q.shape
    plan = flash_kernel_plan(q.dtype, B, L, H, D, 132)
    assert plan["body"] == ("tensor_core" if dtype == "bfloat16"
                            else "tensor_core_f32")
    assert D * q.element_size() % plan["copy_bytes"] == 0
    before = flash_attention.launches
    body_before = flash_attention.body_launches[plan["body"]]
    out = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.body_launches[plan["body"]] == body_before + 1
    ref = flash_attention_reference(
        q, k, v, bias, q.shape[-1] ** -0.5,
        compute_dtype=F32_EXACT if dtype == "float32" else torch.float32)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"max |err| {err}"


# long-context BERT's sequences at BERT-large's heads, the last tenth of
# the keys padded: 16-64 key tiles of the tensor-core body's online
# softmax.  Outputs shrink as L grows, so bf16 is held, besides TOL, to
# BF16_LONG_TOL's ratios to the plain version's scale
LONG_FLASH_SHAPES = {"long_L1024": (1, 1024, 102), "long_L2048": (1, 2048, 204),
                     "long_L4096": (1, 4096, 409)}


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(LONG_FLASH_SHAPES))
def test_flash_attention_long_sequences_match_plain_version(card, name,
                                                            dtype):
    B, L, tail = LONG_FLASH_SHAPES[name]
    rng = np.random.default_rng(700 + sorted(LONG_FLASH_SHAPES).index(name))
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, 16, 64))
                                .astype(np.float32)).to("cuda", dt)
               for _ in range(3))
    bias = torch.zeros(B, L)
    bias[:, -tail:] = -10000.0
    bias = bias.to("cuda", dt)
    out = flash_attention(q, k, v, bias)
    ref = flash_attention_reference(q, k, v, bias, 64 ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    got = agreement(out, ref)
    assert got["max_abs_err"] <= TOL[dtype], got
    if dtype == "bfloat16":
        assert all(got[k] <= tol for k, tol in BF16_LONG_TOL.items()), got


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_flash_attention_fully_masked_row_is_finite_and_uniform(card, dtype):
    """Every key of every row carries bias -1e4 and batch 0's queries are
    zero: its scores are all equal, so its softmax is uniform and its
    output the mean of v over the keys (in either body)."""
    q, k, v, bias = _flash_case("all_keys_masked", dtype)
    q[0] = 0
    out = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    mean = v[0].float().mean(dim=0, keepdim=True).expand_as(out[0])
    err = (out[0].float() - mean).abs().max().item()
    assert err <= TOL[dtype], f"max |err| {err}"


def test_flash_attention_gradient_is_the_plain_versions(card):
    """The backward recomputes the plain version in float32, so the
    kernel's gradients are autograd through the plain version (the same
    arithmetic; 1e-6 covers another GEMM algorithm choice)."""
    q, k, v, bias = (t.requires_grad_(True)
                     for t in _flash_case("indivisible_L100", "float32"))
    g = torch.randn_like(q)
    grads = torch.autograd.grad(flash_attention(q, k, v, bias), (q, k, v,
                                                                 bias), g)
    ref = torch.autograd.grad(
        flash_attention_reference(q, k, v, bias, q.shape[-1] ** -0.5),
        (q, k, v, bias), g)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_flash_attention_rejects_what_the_kernel_does_not_take(card):
    q, k, v, bias = _flash_case("indivisible_L100", "float32")
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, bias)
    with pytest.raises(ValueError, match="k must be"):
        flash_attention(q, k.double(), v, bias)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, k, v, bias[:, :-1])
    with pytest.raises(TypeError, match="bias"):
        flash_attention(q, k, v, bias.double())
