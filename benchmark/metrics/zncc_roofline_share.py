"""zncc_roofline_share: the least time of the ZNCC searches the window's
pairs needed (each pair matched: the matcher's searches reckoned from the
frame size, benchmark.yardstick.match_seconds) over the device time of the
ZNCC kernels in the trace, in %. The program counts its ZNCC launches but
not their shapes; the reckoning holds only where the launches are whole
matcher calls (1 + levels each) and cover every pair."""

import math

from benchmark.yardstick import match_levels, match_seconds

KERNELS = ("zscore_kernel", "search_kernel", "reduce_kernel")
SUBBATCH = 4  # pairs a matcher call at most


def read(ctx):
    t = sum(b - a for name, a, b in ctx.ops
            if any(k in name for k in KERNELS)) / 1e9
    H, W = ctx.frame_hw
    per_call = 1 + match_levels(H, W)
    n = ctx.attempted
    if (t <= 0 or not n or ctx.zncc_launches % per_call
            or ctx.zncc_launches // per_call < math.ceil(n / SUBBATCH)):
        return None
    return 100.0 * n * match_seconds(H, W) / t
