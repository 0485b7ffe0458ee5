"""Paged-attention port contracts: the port's plain version against the
JAX package's Pallas kernels (interpret mode) and its XLA reference,
over fp pools and over int8 pools with per-page-per-head scales.

The cases are ``tools/paged_attention_smoke.py``'s edge cases — a
sequence crossing a page boundary, sentinel-padded tables, a full wave,
the speculative-verify query length — plus the two shapes the serving
engine adds: a prefill wave (``Lq = bucket``) with all-pad rows, and a
decode wave with inactive rows (``index = 0``, all-sentinel tables).
The CUDA kernel itself runs only on the card: ``test_torch_cuda.py``
compares it with this plain version there.
"""

import numpy as np
import pytest
import torch

from skycomputing_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_attention_reference,
)
from skycomputing_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)

pytestmark = pytest.mark.torch_port

P, PS, H, D = 10, 4, 2, 16


def _tables(rows):
    t = np.full((len(rows), max(len(r) for r in rows) or 1), P, np.int32)
    for i, r in enumerate(rows):
        t[i, : len(r)] = r
    return t


# (R, Lq, tables, index)
CASES = {
    "page_boundary_1row": (1, 1, _tables([[7, 2, 5]]), [8]),
    "sentinel_padded_wave": (
        3, 1, _tables([[7, 2, 5], [0, 9], [1, 3, 4, 6, 8]]), [8, 4, 16]),
    "sentinel_heavy": (2, 1, np.array([[3, P, P, P], [1, P, P, P]],
                                      np.int32), [0, 2]),
    "verify_shape_lq3": (
        3, 3, _tables([[7, 2, 5], [0, 9], [1, 3, 4, 6, 8]]), [6, 2, 14]),
    "verify_full_wave_lq4": (
        3, 4, _tables([[7, 2, 5], [0, 9], [1, 3, 4, 6, 8]]), [5, 0, 12]),
    # a prefill wave: row 0 shares 4 tokens and appends 8 (index 4),
    # row 1 is fresh, rows 2-3 are pad rows with all-sentinel tables
    "prefill_lq8_pad_rows": (
        4, 8, np.array([[2, 6, 8, P], [5, 1, P, P], [P] * 4, [P] * 4],
                       np.int32), [4, 0, 0, 0]),
    # a decode wave with inactive rows (index 0, all sentinels)
    "decode_inactive_rows": (
        4, 1, np.array([[4, 7, P], [P, P, P], [9, 0, 3], [P, P, P]],
                       np.int32), [5, 0, 10, 0]),
}


def _sees_no_sentinel(table, index, Lq):
    """Rows whose visible positions (``< index + Lq``) all map to real
    pages."""
    last_page = (np.asarray(index) + Lq - 1) // PS
    return np.array([
        (table[r, : min(last_page[r] + 1, table.shape[1])] < P).all()
        for r in range(table.shape[0])
    ])


def _inputs(seed, R, Lq):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R, Lq, H, D)).astype(np.float32)
    k = rng.standard_normal((P, PS, H, D)).astype(np.float32)
    v = rng.standard_normal((P, PS, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel_and_reference(name):
    """The port's plain version equals the Pallas kernel (interpret
    mode) and the XLA reference to 1e-5 on every edge case, and CPU
    calls never count as kernel launches."""
    R, Lq, table, index = CASES[name]
    index = np.asarray(index, np.int32)
    q, k, v = _inputs(sorted(CASES).index(name), R, Lq)
    launches = paged_attention.launches
    out = paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(table),
                          torch.from_numpy(index)).numpy()
    assert paged_attention.launches == launches == 0
    assert out.shape == (R, Lq, H, D) and np.isfinite(out).all()
    kern = np.asarray(jax_paged_attention(q, k, v, table, index,
                                          interpret=True))
    ref = np.asarray(jax_paged_attention_reference(q, k, v, table, index))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=0)
    # the XLA reference clips sentinel positions instead of clamping the
    # page, so it agrees wherever no sentinel lies in a row's visible
    # span — every live row; pad and inactive rows are garbage by design
    live = _sees_no_sentinel(table, index, Lq)
    assert live.any()
    np.testing.assert_allclose(out[live], ref[live], atol=1e-5, rtol=0)


# (R, Lq, tables, index) at head dims whose K/V rows are not whole
# 16-byte chunks in some page type: a decode wave whose rows cross pages
# and whose tables hold sentinels, and a prefill wave with a pad row
ODD_CASES = {
    "decode": CASES["sentinel_padded_wave"],
    "prefill": CASES["prefill_lq8_pad_rows"],
}


def _odd_inputs(seed, R, Lq, D, int8):
    """``_inputs`` / ``_int8_inputs`` at head_dim ``D``: (q, k, v, scales
    or None)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R, Lq, H, D)).astype(np.float32)
    if not int8:
        k, v = (rng.standard_normal((P, PS, H, D)).astype(np.float32)
                for _ in range(2))
        return q, k, v, None
    k, v = (rng.integers(-127, 128, (P, PS, H, D)).astype(np.int8)
            for _ in range(2))
    scales = tuple(rng.uniform(0.005, 0.03, (P, H)).astype(np.float32)
                   for _ in range(2))
    return q, k, v, scales


@pytest.mark.parametrize("wave", sorted(ODD_CASES))
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("D", [30, 36, 37, 40])
def test_odd_head_dims_match_jax_kernel_and_reference(D, int8, wave):
    """At head_dims 30, 36, 37 and 40 (float32 rows of 120, 144, 148 and
    160 bytes; int8 rows of 30, 36, 37 and 40, which the card stages
    padded to whole 16-byte slots) the plain version equals the Pallas
    kernel in interpret mode to 1e-5 over fp and int8 pools, and the XLA
    reference on every live row."""
    R, Lq, table, index = ODD_CASES[wave]
    index = np.asarray(index, np.int32)
    q, k, v, scales = _odd_inputs(70 + D + 5 * int8 + (wave == "prefill"),
                                  R, Lq, D, int8)
    kw = {} if scales is None else dict(k_scale=scales[0],
                                        v_scale=scales[1])
    out = paged_attention(
        *map(torch.from_numpy, (q, k, v, table, index)),
        **{name: torch.from_numpy(a) for name, a in kw.items()}).numpy()
    assert out.shape == (R, Lq, H, D) and np.isfinite(out).all()
    kern = np.asarray(jax_paged_attention(q, k, v, table, index,
                                          interpret=True, **kw))
    ref = np.asarray(jax_paged_attention_reference(q, k, v, table, index,
                                                   **kw))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=0)
    live = _sees_no_sentinel(table, index, Lq)
    assert live.any()
    np.testing.assert_allclose(out[live], ref[live], atol=1e-5, rtol=0)


def test_scalar_index_and_softmax_scale_match_jax():
    """A scalar ``index`` broadcasts over rows and an explicit
    ``softmax_scale`` replaces ``D**-0.5``, as in the JAX function."""
    R, Lq, table, _ = CASES["verify_shape_lq3"]
    q, k, v = _inputs(11, R, Lq)
    out = paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), 3, softmax_scale=0.5).numpy()
    ref = np.asarray(jax_paged_attention(
        q, k, v, table, 3, softmax_scale=0.5, interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_wrapper_keeps_bfloat16_on_cpu():
    """The output keeps q's dtype (the kernel's contract) on the CPU
    path too."""
    R, Lq, table, index = CASES["sentinel_padded_wave"]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(12, R, Lq))
    out = paged_attention(q, k, v, torch.from_numpy(table),
                          torch.tensor(index, dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def _int8_inputs(seed, R, Lq):
    """The JAX int8 kernel test's inputs: int8 pages uniform in
    [-127, 127], scales uniform in [0.005, 0.03] per (page, head)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R, Lq, H, D)).astype(np.float32)
    k = rng.integers(-127, 128, (P, PS, H, D)).astype(np.int8)
    v = rng.integers(-127, 128, (P, PS, H, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, (P, H)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, (P, H)).astype(np.float32)
    return q, k, v, ks, vs


@pytest.mark.parametrize("name", ["sentinel_padded_wave",
                                  "prefill_lq8_pad_rows",
                                  "verify_full_wave_lq4",
                                  "decode_inactive_rows"])
def test_int8_plain_version_matches_jax_kernel_and_reference(name):
    """Over an int8 pool (kernel B3's contract) the plain version equals
    JAX's ``_paged_kernel_int8`` in interpret mode and its dequantizing
    XLA reference to 1e-5 — decode, prefill with pad rows, and the
    speculative-verify query length; CPU calls launch nothing."""
    R, Lq, table, index = CASES[name]
    index = np.asarray(index, np.int32)
    q, k, v, ks, vs = _int8_inputs(40 + sorted(CASES).index(name), R, Lq)
    launches = (paged_attention.launches, paged_attention_int8.launches)
    out = paged_attention(
        *map(torch.from_numpy, (q, k, v, table, index)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    assert (paged_attention.launches,
            paged_attention_int8.launches) == launches == (0, 0)
    assert out.shape == (R, Lq, H, D) and np.isfinite(out).all()
    kern = np.asarray(jax_paged_attention(q, k, v, table, index,
                                          k_scale=ks, v_scale=vs,
                                          interpret=True))
    ref = np.asarray(jax_paged_attention_reference(
        q, k, v, table, index, k_scale=ks, v_scale=vs))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=0)
    live = _sees_no_sentinel(table, index, Lq)
    np.testing.assert_allclose(out[live], ref[live], atol=1e-5, rtol=0)


def test_int8_scales_must_come_in_pairs():
    """One scale without the other raises, as in JAX, on both the
    wrapper and the plain version."""
    R, Lq, table, index = CASES["sentinel_padded_wave"]
    q, k, v, ks, _ = map(torch.from_numpy, _int8_inputs(50, R, Lq))
    args = (q, k, v, torch.from_numpy(table),
            torch.tensor(index, dtype=torch.int32))
    with pytest.raises(ValueError, match="together"):
        paged_attention(*args, k_scale=ks)
    with pytest.raises(ValueError, match="together"):
        paged_attention_reference(*args, v_scale=ks)
