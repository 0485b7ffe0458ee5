"""Plain float32 BERT classifier: forward, loss and SGD steps.

The published BERT encoder (Devlin et al., 2019; google-research/bert's
``modeling.py``): word + position + token-type embeddings, LayerNorm
(eps 1e-12); per layer, multi-head self-attention with the additive key
mask ``(1 - mask) * -10000`` and scale ``1/sqrt(head_dim)``, output
projection, residual and LayerNorm, then the exact (erf) GELU FFN,
residual and LayerNorm; the pooler (tanh of a dense layer on the first
token) and a linear classifier; cross-entropy averaged over the rows;
plain SGD.  Hidden dropout (after the embeddings' LayerNorm, on each
layer's attention output and FFN output before their residuals, and on
the pooled output before the classifier) applies masks handed in from
outside, scaled by ``1 / (1 - hidden_dropout_prob)``: the reference
draws none of its own, so that it can follow the masks another run drew.
Attention-probability dropout is not modelled (the cells run it at 0).

Parameters are a list of per-unit dicts in the order of the pipeline's
units (embeddings, then head, body and tail of each layer, pooler,
classifier), under the key names of :func:`layout`.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .precision import quantizer


def layout(cfg: dict, num_classes: int) -> list:
    """``[(key, shape, init kind)]`` per unit (see ``harness.weights``)."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]

    def dense(name, n_in, n_out, kind="w"):
        return [(f"{name}.weight", (n_out, n_in), kind),
                (f"{name}.bias", (n_out,), "b")]

    def norm(name):
        return [(f"{name}.weight", (H,), "g"), (f"{name}.bias", (H,), "b")]

    units = [[
        ("word_embeddings.weight", (cfg["vocab_size"], H), "w"),
        ("position_embeddings.weight", (cfg["max_position_embeddings"], H),
         "w"),
        ("token_type_embeddings.weight", (cfg["type_vocab_size"], H), "w"),
        *norm("LayerNorm"),
    ]]
    for _ in range(cfg["num_hidden_layers"]):
        units.append([*dense("self.query", H, H), *dense("self.key", H, H),
                      *dense("self.value", H, H),
                      *dense("output.dense", H, H),
                      *norm("output.LayerNorm")])
        units.append(dense("dense_act", H, I))
        units.append([*dense("dense", I, H), *norm("LayerNorm")])
    units.append(dense("dense_act", H, H))
    units.append(dense("classifier", H, num_classes, kind="fan"))
    return units


class MaskMismatch(ValueError):
    """The masks handed in do not cover the reference's dropout sites
    and rows."""


def dropout_units(num_layers: int) -> list:
    """The units that carry a hidden dropout site, in unit order: the
    embeddings, each layer's head (attention output) and tail (FFN
    output), and the classifier."""
    return ([0] + [u for layer in range(num_layers)
                   for u in (1 + 3 * layer, 3 + 3 * layer)]
            + [3 * num_layers + 2])


def draw_masks(cfg: dict, batch: int, seq: int, steps: int, seed: int,
               device) -> list:
    """Hidden dropout masks for ``steps`` steps from ``seed`` on
    ``device`` (keep with probability ``1 - hidden_dropout_prob``), as
    :func:`train` takes them: per step ``{unit: bool [batch, seq,
    hidden]}`` (``[batch, hidden]`` at the classifier)."""
    p = float(cfg["hidden_dropout_prob"])
    if p == 0.0:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    H, units = cfg["hidden_size"], dropout_units(cfg["num_hidden_layers"])
    out = []
    for _ in range(steps):
        step = {}
        for u in units:
            shape = (batch, H) if u == units[-1] else (batch, seq, H)
            step[u] = torch.rand(shape, generator=gen, device=device) >= p
        out.append(step)
    return out


def forward(units: Sequence[Dict[str, torch.Tensor]], cfg: dict, ids, types,
            mask, quant=None, masks=None) -> torch.Tensor:
    """Logits [B, classes] in float32; ``masks`` (``{unit: bool}`` over
    these rows, or None for no dropout) are the hidden dropout masks."""
    q = quantizer(quant)
    keep = 1.0 - float(cfg["hidden_dropout_prob"])

    def drop(x, unit):
        if masks is None:
            return x
        return x * masks[unit].to(x.device, x.dtype) / keep

    H = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    D = H // heads
    B, L = ids.shape

    def linear(x, p, name):
        return F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])

    def norm(x, p, name):
        return F.layer_norm(x, (H,), p[f"{name}.weight"], p[f"{name}.bias"],
                            1e-12)

    def split(x):
        return x.view(B, L, heads, D).transpose(1, 2)

    emb = units[0]
    x = (emb["word_embeddings.weight"][ids.long()]
         + emb["position_embeddings.weight"][:L][None]
         + emb["token_type_embeddings.weight"][types.long()])
    x = drop(norm(x, emb, "LayerNorm"), 0)
    key_bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    for layer in range(cfg["num_hidden_layers"]):
        head, body, tail = units[1 + 3 * layer: 4 + 3 * layer]
        qh = split(linear(x, head, "self.query"))
        kh = split(linear(x, head, "self.key"))
        vh = split(linear(x, head, "self.value"))
        scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(D) + key_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = (q(probs) @ q(vh)).transpose(1, 2).reshape(B, L, H)
        x = norm(drop(linear(ctx, head, "output.dense"), 1 + 3 * layer) + x,
                 head, "output.LayerNorm")
        inter = F.gelu(linear(x, body, "dense_act"))
        x = norm(drop(linear(inter, tail, "dense"), 3 + 3 * layer) + x,
                 tail, "LayerNorm")
    pooled = torch.tanh(linear(x[:, 0], units[-2], "dense_act"))
    return linear(drop(pooled, len(units) - 1), units[-1], "classifier")


def train(units: Sequence[Dict[str, torch.Tensor]], cfg: dict,
          batches: Sequence, lr: float, block_rows: int, quant=None,
          rows=None, masks=None) -> Dict:
    """SGD at ``lr`` from ``units`` over ``batches`` (each ``(ids, types,
    mask, labels)``), gradients summed over blocks of ``block_rows`` rows
    so that a batch fits; ``rows`` limits each batch to its first rows
    (the half-batch fault).  ``masks``: per step the hidden dropout
    masks over the whole batch (``{unit: bool}``, see :func:`draw_masks`;
    None where the configuration has no dropout).  Returns each step's
    mean loss and float32 logits [rows, classes]; every leaf's
    first gradient's norm as the optimizer's state after one step gives
    it (the change over the step over ``lr``: float32 rounds that change,
    as it rounds the program's) and as autograd gives it
    (``raw_grad_norms``); and every leaf's change over all steps.
    ``units`` are left untouched."""
    params = [{k: v.detach().clone().requires_grad_(True)
               for k, v in u.items()} for u in units]
    flat = [(f"{i}:{k}", p) for i, u in enumerate(params)
            for k, p in u.items()]
    originals = {f"{i}:{k}": v for i, u in enumerate(units)
                 for k, v in u.items()}
    sites = set(dropout_units(cfg["num_hidden_layers"]))
    if masks is not None and (len(masks) < len(batches) or any(
            set(m) != sites or any(t.shape[0] < ids.shape[0]
                                   for t in m.values())
            for m, (ids, *_) in zip(masks, batches))):
        raise MaskMismatch("dropout masks do not cover the reference's "
                           f"sites (units {sorted(sites)}) and rows in "
                           "every step")
    losses, all_logits, raw_grad_norms, grad_norms = [], [], {}, {}
    for step, (ids, types, mask, labels) in enumerate(batches):
        n = ids.shape[0] if rows is None else rows
        total, step_logits = 0.0, []
        for r in range(0, n, block_rows):
            e = min(r + block_rows, n)
            block = (None if masks is None else
                     {u: m[r:e] for u, m in masks[step].items()})
            logits = forward(params, cfg, ids[r:e], types[r:e], mask[r:e],
                             quant, block)
            loss = F.cross_entropy(logits, labels[r:e].long(),
                                   reduction="sum") / n
            loss.backward()
            total += float(loss.detach())
            step_logits.append(logits.detach())
        losses.append(total)
        all_logits.append(torch.cat(step_logits))
        with torch.no_grad():
            if step == 0:
                raw_grad_norms = {name: float(p.grad.norm())
                                  for name, p in flat}
            for _, p in flat:
                p -= lr * p.grad
                p.grad = None
            if step == 0:
                grad_norms = {name: float((p - originals[name]).norm()) / lr
                              for name, p in flat}
    with torch.no_grad():
        update_norms = {name: float((p - originals[name]).norm())
                        for name, p in flat}
    return dict(losses=losses, logits=all_logits, grad_norms=grad_norms,
                raw_grad_norms=raw_grad_norms, update_norms=update_norms)
