"""prep_wait_s_per_pair: seconds of para_gen's stage "chunk prep-wait" (the
batched loop's wait for the next chunk's host prep) over the window, per
pair written. The stage timer is the program's and is never reset, so it
is read as a difference over the window."""

STAGE = "chunk prep-wait"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
