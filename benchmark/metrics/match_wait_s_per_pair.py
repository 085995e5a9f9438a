"""match_wait_s_per_pair: seconds of para_gen's matcher stage "matching wait"
(the prep worker blocked on the copy of a pair's ZNCC grids: the searches,
and whatever the device runs before them) over the window, per pair
written. The stage timer is the program's and is never reset, so it is
read as a difference over the window; a program without the stage gives no
reading."""

STAGE = "matching wait"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
