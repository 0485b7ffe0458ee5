"""Plain float32 GPT causal LM: a full forward, and the served-token gaps.

GPT-2 (Radford et al., 2019; openai-community/gpt2-xl): token and
learned position embeddings; per block, pre-LayerNorm (eps 1e-5) causal
multi-head self-attention with scale ``1/sqrt(head_dim)`` and a residual,
then a pre-LayerNorm MLP (hidden -> 4 x hidden -> hidden) and a
residual; a final LayerNorm and the vocabulary projection.  Where the
port's block departs from GPT-2 the reference follows the port, and the
configuration file lists each departure under ``assumed``: the exact
(erf) GELU instead of GPT-2's tanh form, separate q, k and v projections
(GPT-2's fused ``c_attn`` split in three), and an LM head of its own with
a bias instead of the tied token embedding.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .precision import quantizer


def layout(cfg: dict) -> list:
    """``[(key, shape, init kind)]`` per unit: embeddings, (attention,
    MLP) per block, LM head."""
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]

    def dense(name, n_in, n_out):
        return [(f"{name}.weight", (n_out, n_in), "w"),
                (f"{name}.bias", (n_out,), "b")]

    def norm(name):
        return [(f"{name}.weight", (H,), "g"), (f"{name}.bias", (H,), "b")]

    units = [[("wte.weight", (V, H), "w"),
              ("wpe.weight", (cfg["max_position_embeddings"], H), "w")]]
    for _ in range(cfg["num_hidden_layers"]):
        units.append([*norm("ln_1"), *dense("q_proj", H, H),
                      *dense("k_proj", H, H), *dense("v_proj", H, H),
                      *dense("c_proj", H, H)])
        units.append([*norm("ln_2"), *dense("c_fc", H, I),
                      *dense("c_proj", I, H)])
    units.append([*norm("ln_f"), *dense("lm_head", H, V)])
    return units


@torch.no_grad()
def forward(units: Sequence[Dict[str, torch.Tensor]], cfg: dict, ids,
            quant=None) -> torch.Tensor:
    """Logits [L, vocab] in float32 of one sequence ``ids`` [L]."""
    q = quantizer(quant)
    H = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    D = H // heads
    L = ids.shape[0]

    def linear(x, p, name):
        return F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])

    def norm(x, p, name):
        return F.layer_norm(x, (H,), p[f"{name}.weight"], p[f"{name}.bias"],
                            1e-5)

    x = units[0]["wte.weight"][ids.long()] + units[0]["wpe.weight"][:L]
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    for block in range(cfg["num_hidden_layers"]):
        attn, mlp = units[1 + 2 * block: 3 + 2 * block]
        h = norm(x, attn, "ln_1")
        qh, kh, vh = (linear(h, attn, n).view(L, heads, D).transpose(0, 1)
                      for n in ("q_proj", "k_proj", "v_proj"))
        scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(D)
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        ctx = (q(probs) @ q(vh)).transpose(0, 1).reshape(L, H)
        x = x + linear(ctx, attn, "c_proj")
        h = norm(x, mlp, "ln_2")
        x = x + linear(F.gelu(linear(h, mlp, "c_fc")), mlp, "c_proj")
    return linear(norm(x, units[-1], "ln_f"), units[-1], "lm_head")


@torch.no_grad()
def served_gaps(units, cfg: dict, prompt: torch.Tensor, served: torch.Tensor,
                control=None) -> Dict[str, float]:
    """How far each served token's logit lies below the reference's best
    at its position, teacher-forced over ``prompt + served``: the widest
    gap (``gap``) and the count of tokens.  With ``control`` (a precision
    name) also the widest gap of the tokens that the forward in that
    precision puts first at the same positions (``control_gap``)."""
    ids = torch.cat([prompt, served])
    n = served.shape[0]
    rows = slice(prompt.shape[0] - 1, prompt.shape[0] - 1 + n)
    logits = forward(units, cfg, ids)[rows]
    best = logits.max(dim=-1).values
    got = logits.gather(1, served.long()[:, None])[:, 0]
    out = dict(gap=float((best - got).max()), tokens=n)
    if control is not None:
        low = forward(units, cfg, ids, quant=control)[rows].argmax(dim=-1)
        out["control_gap"] = float(
            (best - logits.gather(1, low[:, None])[:, 0]).max())
    return out
