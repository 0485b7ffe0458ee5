"""Sequence-parallel ring attention (the port of
``skycomputing_tpu/parallel/ring_attention.py``), so far its
single-device reference only.

:func:`full_attention_reference` is the O(L^2) float32 path that long
BERT's ``use_flash=False`` takes: einsum scores over ``q * scale`` in
float32, an optional per-key additive ``bias`` ``[B, L]`` and causal
mask, a float32 softmax, the context cast back to q's dtype.
:func:`ring_attention` needs a process group across cards
(``torch.distributed``), which is queue A item 2c of ``ROADMAP.md``; it
raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Optional

import torch


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal=False,
                   scale=None, bias=None):
    """Attention over a sequence sharded across a ring of devices: not
    ported yet (queue A item 2c, with the port's first
    ``torch.distributed`` code)."""
    raise NotImplementedError(
        "ring attention is not ported to PyTorch yet (queue A item 2c: "
        "sequence parallelism over torch.distributed)")


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
