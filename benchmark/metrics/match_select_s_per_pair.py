"""match_select_s_per_pair: seconds of the matcher's stage "matching select"
(the prep worker's host selection of a pair's matches from its grids: the
kNN coherence passes) over the window, per pair written. The stage timer
is the program's and is never reset, so it is read as a difference over
the window; a program without the stage gives no reading."""

STAGE = "matching select"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
