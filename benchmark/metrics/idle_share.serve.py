"""Share of the traced slice in which no kernel, copy or set ran on the
card, in %."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
