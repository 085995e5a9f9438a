"""dispatch_s_per_pair: seconds of para_gen's stage "chunk dispatch" (the
host's dispatch of a chunk's solves) over the window, per pair written.
The stage timer is the program's and is never reset, so it is read as a
difference over the window."""

STAGE = "chunk dispatch"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
