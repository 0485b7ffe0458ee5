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
    B, L, H, D = q.shape
    if L % S:
        raise ValueError(
            f"ring attention needs sequence length ({L}) divisible by the "
            f"{axis_name} axis size ({S})")
    Lb = L // S
    has_bias = bias is not None
    k_cur = _seq_blocks(k, S, devices)
    v_cur = _seq_blocks(v, S, devices)
    b_cur = _seq_blocks(bias, S, devices) if has_bias else None

    state = []
    for idx, (q_blk, dev) in enumerate(zip(_seq_blocks(q, S, devices),
                                           devices)):
        state.append([
            q_blk.float() * scale,
            torch.zeros(B, Lb, H, D, dtype=torch.float32, device=dev),
            torch.full((B, H, Lb), -torch.inf, dtype=torch.float32,
                       device=dev),
            torch.zeros(B, H, Lb, dtype=torch.float32, device=dev),
            idx * Lb + torch.arange(Lb, device=dev),
        ])

    for i in range(S):
        for idx, st in enumerate(state):
            q_f32, o, m, l, q_pos = st
            scores = torch.einsum("bqhd,bkhd->bhqk", q_f32,
                                  k_cur[idx].float())
            if has_bias:
                scores = scores + b_cur[idx].float()[:, None, None, :]
            if causal:
                src = (idx - i) % S
                k_pos = src * Lb + torch.arange(Lb, device=q_pos.device)
                allowed = q_pos[:, None] >= k_pos[None, :]
                scores = torch.where(allowed[None, None], scores,
                                     -torch.inf)
            st[1], st[2], st[3] = _online_block_update(o, m, l, scores,
                                                       v_cur[idx])
        if i + 1 < S:
            # position idx receives its left neighbour's block
            k_cur = [k_cur[idx - 1].to(dev) for idx, dev in enumerate(devices)]
            v_cur = [v_cur[idx - 1].to(dev) for idx, dev in enumerate(devices)]
            if has_bias:
                b_cur = [b_cur[idx - 1].to(dev)
                         for idx, dev in enumerate(devices)]

    # fully masked rows have l == 0: 0 / 1e-30 gives 0, not NaN
    outs = [(o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None])
            .to(q.dtype).to(q.device) for _, o, _, l, _ in state]
    return torch.cat(outs, dim=1)


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


__all__ = ["full_attention_reference", "ring_attention"]
