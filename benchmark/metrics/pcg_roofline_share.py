"""pcg_roofline_share: the least time of the PCG work the window's jobs
needed over the device time of the PCG kernel in the trace, in %.

The work is counted from the inputs: every problem of a job on its solve
box (the reference's tight box around the segment or frame's solve
region, ``benchmark.reference.pipeline.solve_box``), the schedule's GN
steps a problem, each at its PCG iterations
(``benchmark.yardstick.pcg_seconds``), whatever canvas or batch the
program pads it into. The program's launch counter only checks the count
of problems: where the program solved another number, the reckoning does
not stand for its work, and the metric is left out."""

import sys

from benchmark.yardstick import pcg_seconds

KERNEL = "pcg_cluster"


def read(ctx):
    t = sum(b - a for name, a, b in ctx.ops if KERNEL in name) / 1e9
    if t <= 0 or not ctx.pcg_shapes or not ctx.solve_boxes:
        return None
    solved = sum(B * n for (B, _, _), n in ctx.pcg_shapes.items())
    need = ctx.jobs * ctx.gn_calls * len(ctx.solve_boxes)
    if solved != need:
        print(f"pcg_roofline_share: the program made {solved} problem-calls,"
              f" the inputs need {need}; left out", file=sys.stderr)
        return None
    least = ctx.jobs * ctx.gn_calls * sum(
        pcg_seconds(1, h, w, ctx.pcg_iters) for h, w in ctx.solve_boxes)
    return 100.0 * least / t
