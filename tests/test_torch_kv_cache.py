"""Paged KV-cache port contracts: the port's write, gather and
visibility math against the JAX package's on the same inputs, for fp
pools and for int8 pools (``QuantizedPages``).

The fp writes are checked on slabs filled with noise (not zeros), so a
write that should have dropped — a pad-tail position past
``valid_len``, or a position whose table entry is a sentinel — shows
as a changed value.  The int8 quantizer must give identical int8 values
and identical scales: ``round`` is half-to-even and ``amax / 127`` an
exact IEEE division on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skycomputing_tpu.serving import kv_cache as jkv
from skycomputing_tpu_torch.serving import kv_cache as tkv

pytestmark = pytest.mark.torch_port

P, PS, H, D = 8, 4, 2, 8


def _slabs(rng):
    return (rng.standard_normal((P, PS, H, D)).astype(np.float32),
            rng.standard_normal((P, PS, H, D)).astype(np.float32))


WRITES = {
    # prefill wave: row 0 fresh with a pad tail (valid 6 of 8), row 1
    # appends after a 3-token shared prefix, row 2 is an all-pad row
    "prefill_pad_tail": (
        np.array([[3, 1, P], [5, 2, 0], [P, P, P]], np.int32),
        [0, 3, 0], [6, 9, 0], 8),
    # decode: active rows write one position, the inactive row drops
    "decode_inactive": (
        np.array([[3, 1, P], [P, P, P], [6, 4, 7]], np.int32),
        [5, 0, 9], [6, 0, 10], 1),
    # a span that runs past the row's table into sentinel entries
    "sentinel_overrun": (
        np.array([[2, P], [7, P]], np.int32), [2, 0], [9, 9], 7),
}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_paged_update_kv_matches_jax(name):
    """In-place scatter equals JAX's functional scatter exactly, pad
    and sentinel writes dropped."""
    table, index, valid, Lq = WRITES[name]
    rng = np.random.default_rng(sorted(WRITES).index(name))
    k, v = _slabs(rng)
    R = table.shape[0]
    k_new = rng.standard_normal((R, Lq, H, D)).astype(np.float32)
    v_new = rng.standard_normal((R, Lq, H, D)).astype(np.float32)
    index = np.asarray(index, np.int32)
    valid = np.asarray(valid, np.int32)
    jk, jv = jkv.paged_update_kv(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(k_new), jnp.asarray(v_new),
                                 jnp.asarray(table), jnp.asarray(index),
                                 jnp.asarray(valid))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out_k, out_v = tkv.paged_update_kv(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(table), torch.from_numpy(index),
        torch.from_numpy(valid))
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), k) or valid.max() == 0


def test_write_plan_drops_exactly_the_masked_positions():
    """The plan keeps one write per live position: positions below
    ``valid_len`` whose logical page maps to a real page."""
    table, index, valid, Lq = WRITES["sentinel_overrun"]
    plan = tkv.paged_write_plan(table, index, valid, P, PS, Lq)
    # row 0: positions 2..8 of which 2,3 land on page 2 (4..8 sentinel);
    # row 1: positions 0..6 of which 0..3 land on page 7
    assert sorted(plan.dst.tolist()) == [2 * PS + 2, 2 * PS + 3] + [
        7 * PS + j for j in range(4)]
    assert sorted(plan.src.tolist()) == [0, 1, Lq, Lq + 1, Lq + 2, Lq + 3]


def test_gather_kv_pages_matches_jax():
    rng = np.random.default_rng(7)
    k, v = _slabs(rng)
    table = np.array([[3, 1, P], [P, P, P], [6, 4, 7]], np.int32)
    jk, jv = jkv.gather_kv_pages(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(table))
    tk, tv = tkv.gather_kv_pages(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("index", [3, [0, 5, 2]])
def test_decode_visibility_and_positions_match_jax(index):
    idx = np.asarray(index, np.int32)
    np.testing.assert_array_equal(
        tkv.decode_visibility(torch.from_numpy(idx), 4, 12).numpy(),
        np.asarray(jkv.decode_visibility(jnp.asarray(idx), 4, 12)))
    np.testing.assert_array_equal(
        tkv.decode_positions(torch.from_numpy(idx), 4).numpy(),
        np.asarray(jkv.decode_positions(jnp.asarray(idx), 4)))


def test_spec_and_paged_cache_allocation():
    """Specs match the JAX spec; paged slabs are zeroed in the model
    dtype; the int8 pool is zeroed int8 values plus float32 scale slabs,
    as JAX allocates it; any other kv_dtype is refused."""
    cfg = dict(num_attention_heads=2, hidden_size=64, dtype="bfloat16")
    tspec = tkv.kv_spec_from_config(cfg, 16)
    jspec = jkv.kv_spec_from_config(cfg, 16)
    assert (tspec.max_len, tspec.num_heads, tspec.head_dim, tspec.dtype) \
        == (jspec.max_len, jspec.num_heads, jspec.head_dim, jspec.dtype)
    assert tspec.slab_mb(5) == pytest.approx(jspec.slab_mb(5))
    (k, v), = tkv.init_paged_caches([tspec], 6, 4)
    assert k.shape == (6, 4, 2, 32) and k.dtype == torch.bfloat16
    assert not k.any() and not v.any()
    (kq, vq), = tkv.init_paged_caches([tspec], 6, 4, kv_dtype="int8")
    (jq, _), = jkv.init_paged_caches([jspec], 6, 4, kv_dtype="int8")
    assert isinstance(kq, tkv.QuantizedPages)
    assert kq.values.dtype == torch.int8 and kq.scale.dtype == torch.float32
    assert tuple(kq.values.shape) == jq.values.shape == (6, 4, 2, 32)
    assert tuple(kq.scale.shape) == jq.scale.shape == (6, 2)
    assert not kq.values.any() and not vq.scale.any()
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.init_paged_caches([tspec], 6, 4, kv_dtype="fp8")


# --------------------------------------------------------------------------
# int8 pools: write-time quantization against JAX
# --------------------------------------------------------------------------


def _int8_pair(module, spec):
    (k, v), = module.init_paged_caches([spec], P, PS, kv_dtype="int8")
    return k, v


def _assert_same_int8(tslab, jslab):
    np.testing.assert_array_equal(tslab.values.numpy(),
                                  np.asarray(jslab.values))
    np.testing.assert_array_equal(tslab.scale.numpy(),
                                  np.asarray(jslab.scale))


@pytest.mark.parametrize("case", ["random", "scale_hint", "all_zero"])
def test_quantize_pages_matches_jax(case):
    """Identical int8 values and scales: amax scales, a scale hint that
    floors them (the append rule), and an all-zero page (unit scale)."""
    rng = np.random.default_rng(20)
    pages = (rng.standard_normal((5, PS, H, D))
             * rng.uniform(0.01, 10.0, (5, 1, H, 1))).astype(np.float32)
    hint = None
    if case == "scale_hint":
        hint = rng.uniform(0.0, 0.05, (5, H)).astype(np.float32)
    if case == "all_zero":
        pages[:] = 0.0
    jq, js = jkv.quantize_pages(
        jnp.asarray(pages), None if hint is None else jnp.asarray(hint))
    tq, ts = tkv.quantize_pages(
        torch.from_numpy(pages), None if hint is None else
        torch.from_numpy(hint))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "all_zero":
        assert not tq.any() and bool((ts == 1.0).all())
    if case == "scale_hint":
        assert bool((ts >= torch.from_numpy(hint)).all())


# (Lq, index, valid) per write, applied in turn to one table of 3 rows
INT8_WRITES = {
    # prefill with a mid-page valid_len on row 1 (valid 5 of a 9-token
    # write: the pad tail drops and the page's garbage reads 0), then
    # decode appends and a verify-shaped write that straddles pages
    "midpage_valid_then_appends": [
        (9, [0, 0, 0], [9, 5, 7]), (1, [9, 5, 7], [10, 6, 8]),
        (3, [10, 6, 8], [13, 9, 11]), (5, [13, 9, 11], [16, 11, 16])],
    # a big first token, then small appends: the scale stays monotone
    "monotone_append_scale": [
        (1, [0, 0, 0], [1, 1, 1]), (1, [1, 1, 1], [2, 2, 2]),
        (1, [2, 2, 2], [3, 3, 3])],
    # rows whose first write starts on pages the noise-filled scale slab
    # already holds garbage for: a fresh page ignores the stale scale
    "fresh_page_ignores_stale_scale": [
        (2, [4, 8, 0], [6, 10, 2]), (4, [6, 10, 2], [10, 12, 6])],
    # an all-zero write into a fresh page: scale 1, values 0
    "all_zero_page": [(4, [0, 4, 8], [4, 8, 12])],
}


@pytest.mark.parametrize("name", sorted(INT8_WRITES))
def test_int8_paged_update_kv_matches_jax(name):
    """Quantize-on-write in place equals JAX's functional int8 scatter
    exactly, write after write: values, scales and the dequantized
    gather."""
    rng = np.random.default_rng(30 + sorted(INT8_WRITES).index(name))
    spec_t = tkv.KVCacheSpec(max_len=32, num_heads=H, head_dim=D)
    spec_j = jkv.KVCacheSpec(max_len=32, num_heads=H, head_dim=D)
    tk, tv = _int8_pair(tkv, spec_t)
    jk, jv = _int8_pair(jkv, spec_j)
    if name == "fresh_page_ignores_stale_scale":
        # a previous tenant's garbage in the scale slab
        stale = rng.uniform(0.5, 2.0, (P, H)).astype(np.float32)
        for t in (tk, tv):
            t.scale.copy_(torch.from_numpy(stale))
        jk = jkv.QuantizedPages(jk.values, jnp.asarray(stale))
        jv = jkv.QuantizedPages(jv.values, jnp.asarray(stale))
    table = np.array([[3, 1, 5, P], [0, 2, P, P], [4, 6, 7, P]], np.int32)
    scale_after_first = None
    for step, (Lq, index, valid) in enumerate(INT8_WRITES[name]):
        size = 8.0 if name == "monotone_append_scale" and step == 0 else 1.0
        if name == "monotone_append_scale" and step > 0:
            size = 0.01
        k_new = (size * rng.standard_normal((3, Lq, H, D))).astype(np.float32)
        v_new = (size * rng.standard_normal((3, Lq, H, D))).astype(np.float32)
        if name == "all_zero_page":
            k_new[:] = 0.0
        args = [np.asarray(a, np.int32) for a in (table, index, valid)]
        jk, jv = jkv.paged_update_kv(jk, jv, jnp.asarray(k_new),
                                     jnp.asarray(v_new),
                                     *map(jnp.asarray, args))
        out = tkv.paged_update_kv(tk, tv, torch.from_numpy(k_new),
                                  torch.from_numpy(v_new),
                                  *map(torch.from_numpy, args))
        assert out[0] is tk and out[1] is tv  # in place
        _assert_same_int8(tk, jk)
        _assert_same_int8(tv, jv)
        if step == 0:
            scale_after_first = tk.scale.clone()
            first_view, _ = tkv.gather_kv_pages(tk, tv,
                                                torch.from_numpy(table))
    tg, _ = tkv.gather_kv_pages(tk, tv, torch.from_numpy(table))
    jg, _ = jkv.gather_kv_pages(jk, jv, jnp.asarray(table))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    if name == "midpage_valid_then_appends":
        # row 1's first write ended at 5: its page's tail reads 0
        assert not first_view[1, 5:8].any()
    if name == "monotone_append_scale":
        assert bool((tk.scale[[3, 0, 4]] >=
                     scale_after_first[[3, 0, 4]]).all())
    if name == "all_zero_page":
        assert bool((tk.scale[[3, 2, 7]] == 1.0).all())
        assert not tk.values[[3, 2, 7]].any()
    if name == "fresh_page_ignores_stale_scale":
        # the stale scales (>= 0.5) were far above what the data needs;
        # row 1's first page is a sentinel, so its write dropped
        assert bool((tk.scale[[1, 4, 5, 6]] < 0.5).all())
        assert bool((tk.scale[[0, 2]] >= 0.5).all())


def test_int8_write_plan_skips_rows_that_write_nothing():
    """The int8 plan names, per straddled page, only the rows that write
    a real page there: pad rows (valid 0), sentinel pages and pages past
    the span never appear."""
    table = np.array([[3, 1, P], [P, P, P], [6, 4, 7]], np.int32)
    # Lq 3 over page_size 4 straddles at most 2 pages per row; row 0
    # starts a fresh page 1 at 4, row 2 appends position 7 (valid 8)
    plan = tkv.quantized_write_plan(table, [4, 0, 7], [7, 0, 8], P, PS, 3)
    assert len(plan.pages) == 1
    first, = plan.pages
    assert first.rows.tolist() == [0, 2] and first.phys.tolist() == [1, 4]
    assert first.has_old.reshape(-1).tolist() == [False, True]
    assert first.write_here[0].tolist() == [True, True, True, False]
    assert first.write_here[1].tolist() == [False, False, False, True]
    assert first.live[1].tolist() == [True, True, True, True]
    # two rows crossing a page boundary: both pages are planned
    plan = tkv.quantized_write_plan(table, [2, 0, 6], [5, 0, 9], P, PS, 3)
    assert [(p.rows.tolist(), p.phys.tolist()) for p in plan.pages] == [
        ([0, 2], [3, 4]), ([0, 2], [1, 7])]
