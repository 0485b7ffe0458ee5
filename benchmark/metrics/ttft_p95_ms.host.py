"""TTFT's 95th percentile (ms) over the window's requests, in a cell whose
card is idle most of the time, so that the host paces the tail: the same
number as the end-to-end ``ttft_p95_ms``, reported here beside the
layers."""


def read(ctx):
    tails = ctx.get("tails")
    if not tails or not tails["ttft_count"]:
        return None
    return 1e3 * tails["ttft_p95_s"]
