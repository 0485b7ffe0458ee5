"""Share of the traced slice that the pipeline's host spent issuing work:
the sum of ``PipelineStats.dispatch_s`` over the slice's steps over the
slice's host-clock seconds, in %."""


def read(ctx):
    steps = ctx.get("slice_steps")
    if not steps or not ctx.get("slice_s"):
        return None
    return 100.0 * sum(s["dispatch_s"] for s in steps) / ctx["slice_s"]
