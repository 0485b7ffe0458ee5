"""Paged KV-cache port contracts: the port's write, gather and
visibility math against the JAX package's on the same inputs.

The writes are checked on slabs filled with noise (not zeros), so a
write that should have dropped — a pad-tail position past
``valid_len``, or a position whose table entry is a sentinel — shows
as a changed value.
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
    dtype; the int8 pool is not ported yet and says so."""
    cfg = dict(num_attention_heads=2, hidden_size=64, dtype="bfloat16")
    tspec = tkv.kv_spec_from_config(cfg, 16)
    jspec = jkv.kv_spec_from_config(cfg, 16)
    assert (tspec.max_len, tspec.num_heads, tspec.head_dim, tspec.dtype) \
        == (jspec.max_len, jspec.num_heads, jspec.head_dim, jspec.dtype)
    assert tspec.slab_mb(5) == pytest.approx(jspec.slab_mb(5))
    (k, v), = tkv.init_paged_caches([tspec], 6, 4)
    assert k.shape == (6, 4, 2, 32) and k.dtype == torch.bfloat16
    assert not k.any() and not v.any()
    with pytest.raises(NotImplementedError, match="int8"):
        tkv.init_paged_caches([tspec], 6, 4, kv_dtype="int8")
