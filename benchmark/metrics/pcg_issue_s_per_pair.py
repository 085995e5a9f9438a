"""pcg_issue_s_per_pair: seconds of the solver's stage "pcg launch" (the host
side of each GN step's PCG call: plan lookup and launch) over the window,
per pair written. The stage timer is the program's and is never reset, so
it is read as a difference over the window; a program without the stage
gives no reading."""

STAGE = "pcg launch"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
