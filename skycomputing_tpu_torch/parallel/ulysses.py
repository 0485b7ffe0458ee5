"""Ulysses sequence parallelism: head-parallel attention between two
all-to-alls (the port of ``skycomputing_tpu/parallel/ulysses.py``).

q/k/v ``[B, L, H, D]`` arrive as S sequence blocks, block s on position
s of a 1-d mesh axis.  ``seq_to_heads`` gives position s head group s
of every sequence block (``[B, L, H/S, D]``: the whole sequence for H/S
heads); each position computes ordinary float32 attention over it, with
the per-key bias gathered whole to every position, as ``lax.all_gather``
does; ``heads_to_seq`` returns position s's sequence block of every head
group.  Moves between positions are ``Tensor.to`` of the receiving
position's device, driven by one controller, and gradients flow back
through them by autograd.  On ``meta`` tensors every position is
``meta``.

Requires ``num_heads`` and the sequence length divisible by the mesh
axis's size.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .ring_attention import _seq_blocks, full_attention_reference


def _seq_to_heads(blocks: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Position s gathers head group s of every sequence block."""
    S = len(devices)
    Hs = blocks[0].shape[2] // S
    return [torch.cat([b[:, :, s * Hs:(s + 1) * Hs].to(dev) for b in blocks],
                      dim=1)
            for s, dev in enumerate(devices)]


def _heads_to_seq(blocks: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Position s gathers sequence block s of every head group."""
    S = len(devices)
    Lb = blocks[0].shape[1] // S
    return [torch.cat([b[:, s * Lb:(s + 1) * Lb].to(dev) for b in blocks],
                      dim=2)
            for s, dev in enumerate(devices)]


def check_ulysses(L: int, H: int, S: int, axis_name: str) -> None:
    """Raise where Ulysses cannot split ``H`` heads and a sequence of
    ``L`` over S positions."""
    if H % S != 0:
        raise ValueError(
            f"ulysses needs num_heads ({H}) divisible by the "
            f"{axis_name} axis size ({S})"
        )
    if L % S != 0:
        raise ValueError(
            f"ulysses needs sequence length ({L}) divisible by the "
            f"{axis_name} axis size ({S})"
        )


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention over sequence-sharded q/k/v through head
    all-to-alls over the 1-d ``mesh`` axis ``axis_name``.

    q/k/v: ``[B, L, H, D]`` global tensors; ``bias``: an optional
    additive per-key bias ``[B, L]``.  Returns ``[B, L, H, D]`` in q's
    dtype on q's device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    devices = mesh.ring(axis_name, q)
    S = len(devices)
    check_ulysses(q.shape[1], q.shape[2], S, axis_name)
    qh, kh, vh = (_seq_to_heads(_seq_blocks(x, S, devices), devices)
                  for x in (q, k, v))
    full_bias = [None] * S
    if bias is not None:
        b_blocks = _seq_blocks(bias, S, devices)
        full_bias = [torch.cat([b.to(dev) for b in b_blocks], dim=1)
                     for dev in devices]
    ctx = [full_attention_reference(qh[s], kh[s], vh[s], causal, scale,
                                    bias=full_bias[s])
           for s in range(S)]
    out = _heads_to_seq(ctx, devices)
    return torch.cat([o.to(q.device) for o in out], dim=1)


def ulysses_position(q_blk: torch.Tensor, k_blk: torch.Tensor,
                     v_blk: torch.Tensor, S: int, causal: bool = False,
                     scale: Optional[float] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Position 0's program of :func:`ulysses_attention` as XLA's cost
    analysis counts the JAX version under ``shard_map``: float32
    attention of its H/S heads over the whole sequence, against the
    whole bias ``[B, L]``.  Blocks ``[B, L/S, H, D]``; returns the
    position's output block.  The all-to-alls are moves, so their
    results are shaped here, not gathered.  For the static profile on
    ``meta`` (:func:`~.mesh.one_position`)."""
    B, Lb, H, D = q_blk.shape
    heads = [x.new_empty(B, Lb * S, H // S, D) for x in (q_blk, k_blk, v_blk)]
    full_attention_reference(*heads, causal, scale, bias=bias)
    return q_blk.new_empty(q_blk.shape)


__all__ = ["check_ulysses", "ulysses_attention", "ulysses_position"]
