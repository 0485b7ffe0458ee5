"""B2's tensor-core prefill body's share of its roofline in the traced
slice: the least time of each step's prefill attention over its prompts'
real tokens (causal, ``workcount.b2_prefill_need``, bf16; a step's waves
counted as one call a layer, which never overstates the share), over the
device time of the kernels named ``paged_attention_kernel_mma``, in %."""

from benchmark.harness import workcount
from benchmark.harness.peaks import least_time

KERNEL = "paged_attention_kernel_mma"


def read(ctx):
    trace, log = ctx.get("trace"), ctx.get("slice_log")
    if not trace or not log:
        return None
    seconds = sum(s for name, (_, s) in trace["kernels"].items()
                  if KERNEL in name)
    if not seconds:
        return None
    model = ctx["model"]
    need = sum(least_time(*workcount.b2_prefill_need(
        step["prefill"], model["hidden_size"]), ctx["peaks"])
        for step in log if step["prefill"])
    return 100.0 * need * model["num_hidden_layers"] / seconds
