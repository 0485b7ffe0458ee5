"""B1's share of its roofline in the traced slice: the least time of the
attention forwards the slice's calls needed, over the device time of the
kernels named ``flash_attention_kernel``, in %.

Each call's need comes from the real lengths of its microbatch's rows
(``workcount.b1_call_need``, bf16 operands); a call's microbatch is not
told apart in the trace, so every call is charged the mean need of the
slice's microbatches, which each take the same number of calls."""

from benchmark.harness import workcount
from benchmark.harness.peaks import least_time

KERNEL = "flash_attention_kernel"


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("slice_steps")
    if not trace or not steps:
        return None
    calls = seconds = 0.0
    for name, (n, s) in trace["kernels"].items():
        if KERNEL in name:
            calls += n
            seconds += s
    if not calls or not seconds:
        return None
    model = ctx["model"]
    heads = model["num_attention_heads"]
    head_dim = model["hidden_size"] // heads
    needs = []
    for step in steps:
        lengths = [int(n) for n in step["lengths"]]
        size = len(lengths) // ctx["microbatches"]
        for m in range(ctx["microbatches"]):
            flops, nbytes = workcount.b1_call_need(
                lengths[m * size:(m + 1) * size], heads, head_dim)
            needs.append(least_time(flops, nbytes, ctx["peaks"]))
    return 100.0 * calls * (sum(needs) / len(needs)) / seconds
