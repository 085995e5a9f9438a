"""The yardstick of the roofline shares: published H100 peaks and the least
time each kernel's work needs, counted from what the inputs need (frozen
copies of ``chip_smoke.py``'s ``pcg_bound`` and ``zncc_bound``), not from
how a kernel implementation does it.

A least time is the larger of the bytes the call must move (each input
read once, each output written once) over the HBM bandwidth and its
float32 operations over the peak outside the tensor cores.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# PCG on the ARAP system, per pixel and iteration, with the loop-constant
# planes computed once: JtJ·p 62 (neighbour differences 16, Laplacians 6,
# rotation terms 10, gradient terms 14, assembly 16), p·Ap 6, δ and r
# updates 12, z = pre·r 3, r·z 6, p update 6.
PCG_OPS_PER_PIXEL_ITER = 95
# inputs b, pre (3 planes each), s, c, fit, 4 direction masks; output δ (3)
PCG_PLANES = 13 + 3

# ZNCC search per offset and pixel: the product, a running 12×12 box sum
# (an add and a subtract along each axis) and the running-max compare; the
# z-score per pixel: running sums of p and p² (9) and the mean, variance
# and normalisation (6).
ZNCC_OPS_PER_OFFSET = 6
ZSCORE_OPS = 15


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def pcg_seconds(B: int, H: int, W: int, iters: int) -> float:
    """Least time of one fixed-count PCG call over B problems at H×W."""
    px = B * H * W
    return least_seconds(4.0 * px * PCG_PLANES,
                         float(px) * iters * PCG_OPS_PER_PIXEL_ITER)


def zncc_seconds(N1: int, N2: int, H: int, W: int, r: int) -> float:
    """Least time of one search of N2 planes against N1 at H×W, radius r."""
    n_off = (2 * r + 1) ** 2
    return least_seconds(4.0 * H * W * (N1 + 4 * N2),
                         float(H * W) * (N2 * n_off * ZNCC_OPS_PER_OFFSET
                                         + (N1 + N2) * ZSCORE_OPS))


# The matcher's search plan (a frozen copy of its pyramid's levels and
# radii): a forward and a backward lane a pair, the rotation bank's
# hypotheses at the coarsest level, one refine search a finer level.
MATCH_RADIUS, MATCH_PATCH, MATCH_LEVELS, REFINE_RADIUS = 100, 12, 3, 2
HYPOTHESES = 5


def match_levels(H: int, W: int) -> int:
    """The matcher's clamp: the coarsest level at least ~3 patches across."""
    return max(0, min(MATCH_LEVELS, int(math.floor(
        math.log2(min(H, W) / (3 * MATCH_PATCH))))))


def match_searches(H: int, W: int) -> list:
    """(N1, N2, h, w, r) of every search one pair's match needs."""
    levels = match_levels(H, W)
    radius = min(MATCH_RADIUS, min(H, W))
    shapes = [(H, W)]
    for _ in range(levels):
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    coarse_r = max(2, int(math.ceil(radius / 2 ** levels)))
    hc, wc = shapes[-1]
    out = [(2, 2 * HYPOTHESES, hc, wc, coarse_r)]
    for lvl in range(levels - 1, -1, -1):
        h, w = shapes[lvl]
        out.append((2, 2, h, w, REFINE_RADIUS))
    return out


def match_seconds(H: int, W: int) -> float:
    """Least time of the searches of one pair's match."""
    return sum(zncc_seconds(*s) for s in match_searches(H, W))
