"""gn_replay_s_per_pair: seconds of the solver's stage "gn graph replay"
(the host's issue of each replayed GN step: the copies into the captured
step's static buffers, the operands once a chain and the constraint image
once an anneal step, and the CUDA graph's launch) over the window, per pair
written. The stage timer is the program's and is never reset, so it is
read as a difference over the window; a program without the stage (one
that issues every GN step eagerly) gives no reading. An enqueue that finds
the launch queue full waits for the device, so on a device-bound cell the
stage holds device time: the metric is the crop path's."""

STAGE = "gn graph replay"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
