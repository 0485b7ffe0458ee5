"""Milliseconds of one prefill wave over the window: the engine's
``prefill_s`` over its ``prefill_waves`` (host clock, each wave ending at
the host's read of its first tokens)."""


def read(ctx):
    c0, c1 = ctx["counters"]
    waves = c1["prefill_waves"] - c0["prefill_waves"]
    if not waves:
        return None
    return 1e3 * (c1["prefill_s"] - c0["prefill_s"]) / waves
