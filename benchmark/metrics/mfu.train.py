"""The whole training step's share of the card's bf16 peak over the traced
slice: model FLOPs of the slice's steps (``workcount.bert_step_flops``,
no recomputation) over the slice's seconds, in %."""

from benchmark.harness import workcount


def read(ctx):
    steps = ctx.get("slice_steps")
    if not steps or not ctx.get("slice_s"):
        return None
    flops = len(steps) * workcount.bert_step_flops(
        ctx["model"], ctx["batch"], ctx["seq"], ctx["num_classes"])
    return 100.0 * flops / ctx["slice_s"] / ctx["peaks"]["bf16_flops"]
