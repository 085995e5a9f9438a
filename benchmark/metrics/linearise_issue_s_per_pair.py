"""linearise_issue_s_per_pair: seconds of the solver's stage "gn linearise"
(the host's issue of each GN step's linearisation: trig, JtF and the
diagonal, the preconditioner, the reshapes) over the window, per pair
written. The stage timer is the program's and is never reset, so it is
read as a difference over the window; a program without the stage gives no
reading. An enqueue that finds the launch queue full waits for the device,
so on a device-bound cell the stage holds device time: the metric is the
crop path's."""

STAGE = "gn linearise"


def read(ctx):
    if not ctx.pairs or STAGE not in ctx.stages:
        return None
    return ctx.stages[STAGE] / ctx.pairs
