"""Milliseconds of one decode tick over the window: the engine's
``decode_s`` over its ``decode_ticks`` (host clock, each tick ending at
the host's read of its tokens)."""


def read(ctx):
    c0, c1 = ctx["counters"]
    ticks = c1["decode_ticks"] - c0["decode_ticks"]
    if not ticks:
        return None
    return 1e3 * (c1["decode_s"] - c0["decode_s"]) / ticks
