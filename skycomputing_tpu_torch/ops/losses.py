"""Loss functions, registry-named after their reference torch
counterparts (the port of ``skycomputing_tpu/ops/losses.py``).  Each
takes logits and integer labels (or float targets) and returns a scalar
float32 tensor; the math is in float32 whatever the logits' dtype."""

from __future__ import annotations

import functools
import inspect

import torch
import torch.nn.functional as F

from ..registry import LOSS


@LOSS.register_module(name="CrossEntropyLoss")
def cross_entropy_loss(logits, labels):
    return F.cross_entropy(logits.float(), labels.long())


@LOSS.register_module(name="MSELoss")
def mse_loss(predictions, targets):
    return torch.mean((predictions.float() - targets) ** 2)


@LOSS.register_module(name="CausalLmLoss")
def causal_lm_loss(logits, labels, mask=None, pad_id=None):
    """Next-token cross entropy; labels are the (unshifted) input ids.

    Padding must not be trained on: pass ``mask`` (1 = real token, aligned
    with ``labels``) and/or ``pad_id`` (targets equal to it are ignored)
    to get a masked mean over real target positions only.  With neither,
    every position counts — correct only for unpadded batches.
    """
    lg = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    per_token = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                targets.reshape(-1),
                                reduction="none").reshape(targets.shape)
    target_mask = None
    if mask is not None:
        target_mask = mask[:, 1:].float()
    if pad_id is not None:
        pad_mask = (targets != pad_id).float()
        target_mask = (
            pad_mask if target_mask is None else target_mask * pad_mask
        )
    if target_mask is None:
        return per_token.mean()
    return (per_token * target_mask).sum() / target_mask.sum().clamp_min(1.0)


def build_loss(loss_cfg: dict):
    """Resolve ``{'type': <registry name>, **options}``; leftover options
    are partial-applied (e.g. ``{'type': 'CausalLmLoss', 'pad_id': 0}``)."""
    cfg = dict(loss_cfg)
    name = cfg.pop("type")
    fn = LOSS.get_module(name)
    if cfg:
        known = list(inspect.signature(fn).parameters)
        unknown = [k for k in cfg if k not in known]
        if unknown:
            raise ValueError(f"loss {name} got unknown options {unknown}")
        # the first two parameters (predictions, targets) are supplied at
        # call time; binding them here would only surface as a confusing
        # TypeError inside the first train step
        shadowed = [k for k in cfg if k in known[:2]]
        if shadowed:
            raise ValueError(
                f"loss {name} options {shadowed} shadow call-time arguments"
            )
        fn = functools.partial(fn, **cfg)
    return fn


__all__ = ["cross_entropy_loss", "mse_loss", "causal_lm_loss", "build_loss"]
