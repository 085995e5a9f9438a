"""pairs_per_s: pairs written by every job of the window over the time
from the window's start to the last job's end (host clock)."""


def read(ctx):
    return ctx.pairs / ctx.window_s if ctx.window_s > 0 else None
