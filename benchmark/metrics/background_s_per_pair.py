"""background_s_per_pair: seconds of para_gen's stage "background draw" (a
--bg_dir background's decode, random upscale and crop, inside
"background+inputs-io" on the prep worker; one a pair) over the window, per
pair written. The stage timer is the program's and is never reset, so it
is read as a difference over the window; a program without the stage gives
no reading."""

STAGE = "background draw"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
