"""B2's decode body's share of its roofline in the traced slice: the least
time of each decode tick's attention over its rows' live contexts (one
call a layer, ``workcount.b2_decode_need``, bf16 pages), over the device
time of the kernels named ``paged_attention_kernel_decode``, in %."""

from benchmark.harness import workcount
from benchmark.harness.peaks import least_time

KERNEL = "paged_attention_kernel_decode"


def read(ctx):
    trace, log = ctx.get("trace"), ctx.get("slice_log")
    if not trace or not log:
        return None
    seconds = sum(s for name, (_, s) in trace["kernels"].items()
                  if KERNEL in name)
    if not seconds:
        return None
    model = ctx["model"]
    need = sum(least_time(*workcount.b2_decode_need(
        step["decode"], model["hidden_size"]), ctx["peaks"])
        for step in log if step["decode"])
    return 100.0 * need * model["num_hidden_layers"] / seconds
