"""run_arap_prep_s_per_pair: seconds of run_arap's stage "run_arap prep" (a
chunk's PNG and constraint reads, operands, stack and upload) over the
window, per pair written. The stage timer is the program's and is never
reset, so it is read as a difference over the window; a program without
the stage gives no reading."""

STAGE = "run_arap prep"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
