"""decode_s_per_pair: seconds of para_gen's stage "decode+preprocess" (JPEG
decode and any --size resize) over the window, per pair written. The stage
timer is the program's and is never reset, so it is read as a difference
over the window."""

STAGE = "decode+preprocess"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
