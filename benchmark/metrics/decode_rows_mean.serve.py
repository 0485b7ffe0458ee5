"""Rows a decode tick carried, on average over the window: the engine's
``decode_tokens`` over its ``decode_ticks``."""


def read(ctx):
    c0, c1 = ctx["counters"]
    ticks = c1["decode_ticks"] - c0["decode_ticks"]
    if not ticks:
        return None
    return (c1["decode_tokens"] - c0["decode_tokens"]) / ticks
