"""Draft-model speculative decoding for the paged serving engine.

The port of ``skycomputing_tpu/serving/speculative.py``.  A cheap
**draft** proposes ``k`` tokens autoregressively, then the **target**
verifies all ``k + 1`` positions in ONE forward (``models/gpt.
apply_kv_paged`` at ``Lq = k + 1``).  On the greedy path the committed
stream is token-identical to non-speculative decoding by construction:
the target's own argmax at every position is what commits; the draft
only decides how many of those positions one tick may confirm at once.

The draft is a **prefix layer slice sharing the target's modules**
(``models/gpt.draft_slice_indices``): embeddings + the first
``draft_blocks`` transformer blocks + the LM head.  Because the slice is
a prefix, the hidden states entering its layers are exactly the
target's, so the draft's KV cache for those layers IS the first
``draft_blocks`` slab pairs of the target's stage:

- no draft prefill: the target's prefill already wrote the pages;
- no extra KV memory: speculative KV lands in the request's granted
  pages, inside the span its admission already reserved;
- rollback is a watermark truncate: a rejected token's KV sits past the
  request's committed ``index``, masked and later overwritten.

The port's slabs are written in place (an int8 pool's values and scale
slab alike), so the draft hands nothing back for the engine to rebind.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..models.gpt import apply_kv_paged, attn_indices


def greedy_accept_count(
    draft_tokens: Sequence[int], target_tokens: Sequence[int]
) -> int:
    """Accepted draft prefix length under greedy verification: the
    longest prefix where the draft's proposal equals the target's own
    argmax at that position."""
    n = 0
    for d, t in zip(draft_tokens, target_tokens):
        if int(d) != int(t):
            break
        n += 1
    return n


def tree_param_mb(params) -> float:
    """Total MB of the tensors in a parameter tree (state dicts, lists,
    tuples, modules)."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size() / 1024.0 ** 2
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return float(sum(tree_param_mb(p) for p in params))
    return 0.0


class DraftModel:
    """The drafting half of speculative decoding: a prefix slice of the
    target (embeddings + ``draft_blocks`` blocks + LM head) run as
    ``Lq = 1`` paged decode steps on the target's stage, reading and
    writing the first ``num_attn`` (k, v) slab pairs of that stage in
    place.

    ``modules`` is the already-sliced module list (the engine slices the
    full stack with ``models/gpt.draft_slice_indices``); the modules are
    the target's own, the LM head copied to stage 0's device only where
    the last stage's device differs.  ``extra_param_mb`` is the resident
    memory the engine charges for the draft on stage 0 (the head's
    parameters, :func:`tree_param_mb`, whenever the engine has more than
    one stage; 0 on one stage).
    """

    def __init__(self, modules: Sequence[Any], *,
                 extra_param_mb: float = 0.0):
        self.modules = list(modules)
        self.extra_param_mb = float(extra_param_mb)
        self.num_attn = len(attn_indices(self.modules))
        if self.num_attn < 1:
            raise ValueError(
                "draft slice carries no attention unit — nothing to "
                "draft with"
            )

    @torch.no_grad()
    def draft_k(self, tokens, slabs, tables, index, reserve,
                k: int) -> np.ndarray:
        """The whole ``k``-token autoregressive draft: ``tokens`` [rows]
        (each row's last committed token, a tensor on the stage's
        device) in, proposals [rows, k] out as one host array.  Step
        ``j`` writes position ``index + j`` of each row, capped at
        ``reserve`` (the rows' page reservations); ``tables``, ``index``
        and ``reserve`` are host arrays.  Each step's argmax stays on the
        card and feeds the next; the proposals cross to the host once.
        """
        if len(slabs) != self.num_attn:
            raise ValueError(
                f"draft needs {self.num_attn} slab pairs, got "
                f"{len(slabs)}"
            )
        index = np.asarray(index, np.int32)
        reserve = np.asarray(reserve, np.int32)
        cur = tokens
        proposals = []
        for j in range(int(k)):
            idx = index + j
            out, _ = apply_kv_paged(
                self.modules, cur[:, None], slabs, tables, idx,
                np.minimum(idx + 1, reserve),
            )
            cur = out[:, 0].argmax(dim=-1)
            proposals.append(cur)
        return torch.stack(proposals, dim=1).cpu().numpy().astype(np.int32)


__all__ = ["DraftModel", "greedy_accept_count", "tree_param_mb"]
