"""resize_s_per_pair: seconds of para_gen's stage "preprocess resize" (the
--size resize and centre crop of a frame and its mask, inside
"decode+preprocess" on the main thread; two frames a pair) over the window,
per pair written. The stage timer is the program's and is never reset, so
it is read as a difference over the window; a program without the stage
gives no reading."""

STAGE = "preprocess resize"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
