"""run_arap_write_s_per_pair: seconds of run_arap's stage "run_arap write" (a
chunk's .flo and PNG encodes and writes) over the window, per pair
written. The stage timer is the program's and is never reset, so it is
read as a difference over the window; a program without the stage gives no
reading."""

STAGE = "run_arap write"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
