"""TPOT's 95th percentile (ms) over the requests that finished in the
window, in a cell whose card is idle most of the time, so that the host
paces the tail: the same number as the end-to-end ``tpot_p95_ms``,
reported here beside the layers."""


def read(ctx):
    tails = ctx.get("tails")
    if not tails or not tails["tpot_count"]:
        return None
    return 1e3 * tails["tpot_p95_s"]
