"""Seconds the launcher's allocation took in set-up: the static model
profile, the proxy device profile and the solve (host clock)."""


def read(ctx):
    return ctx["alloc_s"]
