"""The whole serving step's share of the card's bf16 peak over the traced
slice: model FLOPs of the prompts prefilled and the tokens decoded in the
slice, from the harness's own request log (``workcount.gpt_prefill_flops``
and ``gpt_decode_flops``), over the slice's seconds, in %."""

from benchmark.harness import workcount


def read(ctx):
    log = ctx.get("slice_log")
    if not log or not ctx.get("slice_s"):
        return None
    model = ctx["model"]
    flops = 0.0
    for step in log:
        flops += sum(workcount.gpt_prefill_flops(model, s, n)
                     for s, n in step["prefill"])
        flops += sum(workcount.gpt_decode_flops(model, c)
                     for c in step["decode"])
    return 100.0 * flops / ctx["slice_s"] / ctx["peaks"]["bf16_flops"]
