"""Sequence-parallel ring attention (the port of
``skycomputing_tpu/parallel/ring_attention.py``).

:func:`ring_attention` splits q/k/v ``[B, L, H, D]`` (and an optional
per-key ``bias`` ``[B, L]``) into S sequence blocks along a 1-d mesh
axis, block s on position s.  Each position keeps its query block and
folds in one key/value block per step with a float32 online softmax
(running max, running sum); between steps the key/value blocks, and the
bias with them where there is one, move one position on around the ring
(``Tensor.to`` of the next position's device).  After S steps each
position holds exact attention for its queries; the blocks are joined
on the caller's device.  The causal mask is over *global* positions:
after i rotations position ``idx`` holds the block that began on
position ``(idx - i) mod S``.

The controller is single: one process drives every position, so the
reverse ring is autograd's, through ``Tensor.to`` and ``torch.cat``, as
JAX gets it from ``jax.grad`` through ``scan`` and ``ppermute``.  The
block products are ``torch.einsum``: the JAX module computes them
outside any Pallas kernel.  On ``meta`` tensors every position is
``meta`` (:meth:`~.mesh.Mesh.ring`), so the pre-flight and the static
profile shape-check and count a mesh-built stack without touching the
mesh's devices.

:func:`full_attention_reference` is the O(L^2) float32 path that long
BERT's ``use_flash=False`` takes: einsum scores over ``q * scale`` in
float32, an optional per-key additive ``bias`` and causal mask, a
float32 softmax, the context cast back to q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def _online_block_update(o, m, l, scores, v_blk):
    """Fold one block of scores/values into the running softmax state."""
    blk_max = scores.amax(dim=-1)                            # [B, H, Lq]
    new_m = torch.maximum(m, blk_max)
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m[..., None])                 # [B, H, Lq, Lk]
    l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    o = o * correction.transpose(1, 2)[..., None] + pv
    return o, new_m, l


def _seq_blocks(x, S: int, devices):
    """``x`` split into S equal blocks along axis 1, block s on
    ``devices[s]``."""
    Lb = x.shape[1] // S
    return [x[:, s * Lb:(s + 1) * Lb].to(devices[s]) for s in range(S)]


def check_ring(L: int, S: int, axis_name: str) -> None:
    """Raise where the ring cannot split a sequence of ``L`` over S
    positions."""
    if L % S:
        raise ValueError(
            f"ring attention needs sequence length ({L}) divisible by the "
            f"{axis_name} axis size ({S})")


def _ring_start(q_blk, scale: float, idx: int) -> list:
    """One position's running state: its scaled float32 queries, the
    output, running max and running sum, its queries' global
    positions."""
    B, Lb, H, D = q_blk.shape
    dev = q_blk.device
    return [
        q_blk.float() * scale,
        torch.zeros(B, Lb, H, D, dtype=torch.float32, device=dev),
        torch.full((B, H, Lb), -torch.inf, dtype=torch.float32, device=dev),
        torch.zeros(B, H, Lb, dtype=torch.float32, device=dev),
        idx * Lb + torch.arange(Lb, device=dev),
    ]


def _ring_step(st: list, k_blk, v_blk, b_blk, causal: bool, src: int):
    """Fold the key/value block that began on position ``src`` into
    ``st`` (the body of JAX's ``scan``)."""
    q_f32, o, m, l, q_pos = st
    scores = torch.einsum("bqhd,bkhd->bhqk", q_f32, k_blk.float())
    if b_blk is not None:
        scores = scores + b_blk.float()[:, None, None, :]
    if causal:
        Lb = k_blk.shape[1]
        k_pos = src * Lb + torch.arange(Lb, device=q_pos.device)
        allowed = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(allowed[None, None], scores, -torch.inf)
    st[1], st[2], st[3] = _online_block_update(o, m, l, scores, v_blk)


def _ring_finish(st: list, dtype) -> torch.Tensor:
    # fully masked rows have l == 0: 0 / 1e-30 gives 0, not NaN
    _, o, _, l, _ = st
    return (o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(
        dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with q/k/v sharded on the sequence axis over the
    1-d ``mesh`` axis ``axis_name``.

    q/k/v: ``[B, L, H, D]`` global tensors; ``bias``: an optional
    additive per-key bias ``[B, L]`` (BERT's ``(1 - mask) * -1e4``),
    rotated with its key blocks.  Returns ``[B, L, H, D]`` in q's dtype
    on q's device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    devices = mesh.ring(axis_name, q)
    S = len(devices)
    check_ring(q.shape[1], S, axis_name)
    has_bias = bias is not None
    k_cur = _seq_blocks(k, S, devices)
    v_cur = _seq_blocks(v, S, devices)
    b_cur = _seq_blocks(bias, S, devices) if has_bias else [None] * S
    state = [_ring_start(q_blk, scale, idx)
             for idx, q_blk in enumerate(_seq_blocks(q, S, devices))]

    for i in range(S):
        for idx, st in enumerate(state):
            _ring_step(st, k_cur[idx], v_cur[idx], b_cur[idx], causal,
                       (idx - i) % S)
        if i + 1 < S:
            # position idx receives its left neighbour's block
            k_cur = [k_cur[idx - 1].to(dev) for idx, dev in enumerate(devices)]
            v_cur = [v_cur[idx - 1].to(dev) for idx, dev in enumerate(devices)]
            if has_bias:
                b_cur = [b_cur[idx - 1].to(dev)
                         for idx, dev in enumerate(devices)]

    return torch.cat([_ring_finish(st, q.dtype).to(q.device)
                      for st in state], dim=1)


def ring_position(q_blk: torch.Tensor, k_blk: torch.Tensor,
                  v_blk: torch.Tensor, causal: bool = False,
                  scale: Optional[float] = None,
                  bias_blk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Position 0's program of :func:`ring_attention` as XLA's cost
    analysis counts the JAX ring under ``shard_map``: one device's set-up,
    the ``scan`` body once (its query block against one key/value block)
    and the division.  Blocks ``[B, L/S, H, D]``, ``bias_blk`` ``[B,
    L/S]``; returns the position's output block.  For the static profile
    on ``meta`` (:func:`~.mesh.one_position`), which charges this and not
    the S positions' S steps that the engine runs."""
    if scale is None:
        scale = q_blk.shape[-1] ** -0.5
    st = _ring_start(q_blk, scale, 0)
    _ring_step(st, k_blk, v_blk, bias_blk, causal, 0)
    return _ring_finish(st, q_blk.dtype)


def full_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Single-device O(L^2) attention.  q/k/v: [B, L, H, D]; ``bias``:
    [B, L] added to every query's scores of that key.  Returns [B, L,
    H, D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if bias is not None:
        scores = scores + bias.float()[:, None, None, :]
    if causal:
        L = q.shape[1]
        allowed = torch.ones(L, L, dtype=torch.bool,
                             device=q.device).tril()
        scores = torch.where(allowed[None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


__all__ = ["check_ring", "full_attention_reference", "ring_attention",
           "ring_position"]
