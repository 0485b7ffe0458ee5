"""Mixture-of-experts routing and dispatch (the port of
``skycomputing_tpu/ops/moe.py``).

A learned router picks the top-k experts of each token; tokens go into
fixed-capacity expert buffers through dense ``[T, E, C]`` dispatch and
combine tensors (static shapes, no data-dependent control flow), the
experts run batched over a leading expert axis, and the outputs are
combined with the gate weights.  Capacity ``C = ceil(T / E *
capacity_factor)``; tokens over capacity get a combine weight of zero
and only the residual path carries them.  The JAX module computes this
with einsums and no Pallas kernel, and so does this one, in plain
PyTorch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def router_probs(tokens: torch.Tensor, router_kernel: torch.Tensor
                 ) -> torch.Tensor:
    """[T, H] x [H, E] -> float32 routing probabilities [T, E]."""
    logits = tokens.float() @ router_kernel.float()
    return torch.softmax(logits, dim=-1)


def top_k_dispatch(probs: torch.Tensor, capacity: int, top_k: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape dispatch and combine tensors from router probs.

    Returns (dispatch [T, E, C] of 0/1 in float32, combine [T, E, C]
    float32, aux_loss scalar).  Each expert's buffer takes tokens in
    order, and every k-th choice queues after every (k-1)-th choice, so
    primary routes win capacity.  ``aux_loss`` is the Switch
    load-balance loss over the primary assignment, ``E * sum_e
    fraction_tokens_e * mean_prob_e``."""
    T, E = probs.shape
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # [T, k]

    dispatch = probs.new_zeros((T, E, capacity))
    combine = probs.new_zeros((T, E, capacity))
    for k in range(top_k):
        onehot = F.one_hot(expert_idx[:, k], E).float()
        # slots already granted to earlier-priority choices
        prior = dispatch.sum(dim=(0, 2)) if k else onehot.new_zeros(E)
        pos = torch.cumsum(onehot, dim=0) - 1.0 + prior[None, :]
        keep = (pos < capacity) & (onehot > 0)
        pos_c = pos.clamp(0, capacity - 1).long()
        slot = F.one_hot(pos_c, capacity).float()
        mask = (keep.float() * onehot)[:, :, None] * slot
        dispatch = dispatch + mask
        combine = combine + mask * gate_vals[:, k][:, None, None]

    primary = F.one_hot(expert_idx[:, 0], E).float()
    frac_tokens = primary.mean(dim=0)
    mean_probs = probs.mean(dim=0)
    aux_loss = E * torch.sum(frac_tokens * mean_probs)
    return dispatch, combine, aux_loss


def moe_route(x: torch.Tensor, router_kernel: torch.Tensor,
              num_experts: int, top_k: int, capacity_factor: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The MoE block's routing of normalized activations x [B, L, H]:
    (tokens [B*L, H], dispatch, combine, aux_loss) at capacity ``C =
    max(1, ceil(B*L / E * capacity_factor))``."""
    H = x.shape[-1]
    tokens = x.reshape(-1, H)
    capacity = max(1, math.ceil(tokens.shape[0] / num_experts
                                * capacity_factor))
    probs = router_probs(tokens, router_kernel)
    return (tokens, *top_k_dispatch(probs, capacity, top_k))


def moe_dispatch(tokens: torch.Tensor, dispatch: torch.Tensor
                 ) -> torch.Tensor:
    """tokens [T, H] -> expert buffers [E, C, H]."""
    return torch.einsum("tec,th->ech", dispatch.to(tokens.dtype), tokens)


def moe_combine(combine: torch.Tensor, expert_out: torch.Tensor
                ) -> torch.Tensor:
    """Expert outputs [E, C, H'] -> gate-weighted tokens [T, H']."""
    return torch.einsum("tec,ech->th", combine.to(expert_out.dtype),
                        expert_out)


def expert_mlp(buf: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: Optional[torch.Tensor],
               act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The experts' two-layer MLP on their buffers, [E, C, H] -> [E, C,
    H'], batched over the leading expert axis; ``b2=None`` leaves the
    output bias to the caller (a row-parallel split adds it after the
    sum)."""
    h = act(torch.einsum("ech,ehi->eci", buf, w1) + b1[:, None, :])
    y = torch.einsum("eci,eih->ech", h, w2)
    return y if b2 is None else y + b2[:, None, :]


def moe_dispatch_combine(tokens: torch.Tensor, dispatch: torch.Tensor,
                         combine: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor]
                         ) -> torch.Tensor:
    """tokens [T, H] -> expert buffers [E, C, H] -> combined [T, H'].
    ``expert_fn`` maps [E, C, H] -> [E, C, H']."""
    return moe_combine(combine, expert_fn(moe_dispatch(tokens, dispatch)))


__all__ = ["expert_mlp", "moe_combine", "moe_dispatch",
           "moe_dispatch_combine", "moe_route", "router_probs",
           "top_k_dispatch"]
