"""The numbers that decide ``correct``, and the judgement against limits.

Training: each checked step's logits (what the last stage handed to the
loss), as the mean over the steps of the norm of their difference over
the reference's norm; the first step's gradient norm per leaf (on both
sides worked out from the optimizer's state after one step) and the
parameters' change per leaf after the checked steps, each leaf's gap
between the program's norm and the reference's measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger, compared as the median leaf's gap.  Notes only: each step's
relative loss gap (a mean over the batch; the fp8 control reads it
under three times what sound runs read, so it can separate nothing),
the worst leaf's gap (it swings from seed to seed: biases next to the
head, whose gradients are sums over the batch that nearly cancel) and
the worst step.  Leaves whose reference gradient (as autograd gives
it) is nought to rounding, under ``EXCLUDE`` of the median leaf's, as a
key bias under softmax, move by round-off alone and are left out, by
that rule and never by name.

Serving: the widest gap by which a served token's logit lies below the
reference's best logit at its position.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

EXCLUDE = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float], kept) -> Tuple:
    """(median leaf gap, the three worst leaves as [leaf, gap, program's
    norm, reference's norm]); a NaN gap counts as infinite."""
    median = statistics.median(ref.values())
    gaps = []
    for name in kept:
        gap = abs(prog[name] - ref[name]) / max(ref[name], median)
        gaps.append((gap if gap == gap else math.inf, name))
    gaps.sort(reverse=True)
    top = [[name, gap, prog[name], ref[name]] for gap, name in gaps[:3]]
    return statistics.median(g for g, _ in gaps), top


def _logit_gaps(prog, ref):
    """Per step ``|program - reference| / |reference|`` of the logits;
    logits missing or of another shape count as infinite."""
    if len(prog) != len(ref) or not ref:
        return [math.inf]
    gaps = []
    for p, r in zip(prog, ref):
        if tuple(p.shape) != tuple(r.shape):
            gaps.append(math.inf)
            continue
        r = r.detach().float().cpu()
        gap = float((p.detach().float().cpu() - r).norm() / r.norm())
        gaps.append(gap if gap == gap else math.inf)
    return gaps


def train_numbers(prog: Dict, ref: Dict) -> Dict:
    """``prog`` and ``ref`` hold ``losses``, ``logits`` (per step),
    ``grad_norms`` and ``update_norms`` (the last two by leaf).
    Compared: the mean over the steps of the relative logit gap, and
    the median leaf's gaps; the loss gaps, the worst leaves and the
    worst step are notes (see the module's docstring)."""
    if len(prog["losses"]) != len(ref["losses"]):
        step_gaps = [math.inf]
    else:
        step_gaps = [abs(p - r) / abs(r)
                     for p, r in zip(prog["losses"], ref["losses"])]
    logit_gaps = _logit_gaps(prog.get("logits") or [], ref["logits"])
    raw = ref.get("raw_grad_norms") or ref["grad_norms"]
    median = statistics.median(raw.values())
    kept = [k for k, v in raw.items() if v >= EXCLUDE * median]
    grad_gap, grad_leaves = _gaps(prog["grad_norms"], ref["grad_norms"],
                                  kept)
    update_gap, update_leaves = _gaps(prog["update_norms"],
                                      ref["update_norms"], kept)
    return dict(
        numbers=dict(logit_gap_mean=sum(logit_gaps) / len(logit_gaps),
                     grad_gap_median=grad_gap,
                     update_gap_median=update_gap),
        notes=dict(leaves=len(ref["grad_norms"]),
                   excluded=len(ref["grad_norms"]) - len(kept),
                   loss_gap_mean=sum(step_gaps) / len(step_gaps),
                   loss_gap_worst_step=max(step_gaps),
                   logit_gaps=logit_gaps,
                   grad_gap_worst=grad_leaves[0][1] if grad_leaves else 0.0,
                   update_gap_worst=(update_leaves[0][1]
                                     if update_leaves else 0.0),
                   losses=[prog["losses"], ref["losses"]],
                   grad_leaves=grad_leaves, update_leaves=update_leaves),
    )


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a limit, or NaN, fails."""
    items, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        items[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, items
