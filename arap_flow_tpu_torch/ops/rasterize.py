"""Forward-warp rasterization by seed scatter and candidate gather
(ops/rasterize.py of the JAX package, whose docstring gives the design and
its calibration). Plain torch: the JAX package computes this outside any
Pallas kernel.

1. Seed scatter: every drawable source quad scatters its linear index to
   the cell its warped corner rounds to, combined by max (the top fold:
   draw priority is row-major source order) and, for the second seed, by
   min (the bottom fold). ``scatter_reduce_`` with amax / amin does not
   depend on the order of the writes, so it is deterministic.
2. Dilation: `dilate` (default 3) 3×3 fill-only max (min) pools fill
   empty cells.
3. For every output pixel, the quads in a rectangle around each seed run
   the reference's LK edge-function coverage test; the accepted triangle
   with the highest draw priority wins. The rectangles are the calibrated
   dual-seed pair unless `window` asks for one square of that side around
   the max seed alone (`anchor` places it; `min_rect` adds a min-seed
   rectangle to it).
4. The winner's corner colours are interpolated barycentrically and
   truncated to whole uint8 values.

A call issues ≈ 2,800 small launches. ``rasterize_replayed`` replays them
as one CUDA graph wherever the shapes repeat (``ops/graphs.py``).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import graphs
from .energy import make_grid


def make_warp(flow: torch.Tensor) -> torch.Tensor:
    """warpField = flow + grid for flow (2, H, W)."""
    H, W = flow.shape[-2:]
    return flow + make_grid(H, W, flow.device)


def _lk_accept(p0x, p0y, p1x, p1y, p2x, p2y, sx, sy):
    """LK edge-function coverage test: (accept, w0, w1, w2). Accepts when the
    triangle is not backfacing (all raw d < 0) and all normalised edge
    functions are ≥ 0 and finite."""
    X0, X1, X2 = p0x - sx, p1x - sx, p2x - sx
    Y0, Y1, Y2 = p0y - sy, p1y - sy, p2y - sy
    d01 = X0 * Y1 - Y0 * X1
    d12 = X1 * Y2 - Y1 * X2
    d20 = X2 * Y0 - Y2 * X0
    backfacing = (d01 < 0) & (d12 < 0) & (d20 < 0)
    ssum = d01 + d12 + d20
    inv = torch.where(ssum == 0.0, torch.inf, 1.0 / ssum)
    n01, n12, n20 = d01 * inv, d12 * inv, d20 * inv
    ok = (~backfacing) & (n01 >= 0) & (n12 >= 0) & (n20 >= 0)
    ok = ok & torch.isfinite(n01) & torch.isfinite(n12) & torch.isfinite(n20)
    return ok, n12, n20, n01


_MIN_EMPTY = 2 ** 31 - 1


def _shift_fill(s: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """b[y, x] = s[y+dy, x+dx], `fill` out of bounds."""
    H, W = s.shape
    out = torch.full_like(s, fill)
    ys = slice(max(dy, 0), H + min(dy, 0))
    yd = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    xd = slice(max(-dx, 0), W + min(-dx, 0))
    out[yd, xd] = s[ys, xs]
    return out


def _seed_map(warp: torch.Tensor, drawable: torch.Tensor, dilate: int,
              combine: str = "max") -> torch.Tensor:
    """(H, W) int64 seed map: the highest (combine='max', −1 where none) or
    lowest (combine='min', _MIN_EMPTY where none) drawable source index
    landing near each cell."""
    H, W = drawable.shape
    is_max = combine == "max"
    empty = -1 if is_max else _MIN_EMPTY
    dev = warp.device
    src_idx = torch.arange(H * W, dtype=torch.int64, device=dev).reshape(H, W)
    # clamp before the integer cast: the same cells as the JAX package's
    # round -> int32 -> clip for every in-range position
    lx = torch.clamp(torch.round(warp[0]), 0, W - 1).to(torch.int64)
    ly = torch.clamp(torch.round(warp[1]), 0, H - 1).to(torch.int64)
    vals = torch.where(drawable, src_idx, empty)
    seeds = torch.full((H * W,), empty, dtype=torch.int64, device=dev)
    seeds.scatter_reduce_(0, (ly * W + lx).reshape(-1), vals.reshape(-1),
                          "amax" if is_max else "amin")
    seeds = seeds.reshape(H, W)
    comb = torch.maximum if is_max else torch.minimum
    for _ in range(dilate):
        nbr = seeds
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    nbr = comb(nbr, _shift_fill(seeds, dy, dx, empty))
        # fill-only: occupied cells keep their (accurate) seed
        seeds = torch.where(seeds == empty, nbr, seeds)
    return seeds


# dual-seed candidate rects (y0, y1, x0, x1), inclusive offsets around the
# max seed and the min seed: the JAX package's calibrated defaults
_MAX_RECT = (-2, 0, -2, 1)
_MIN_RECT = (-1, 1, -1, 0)


def _rects(window, anchor, min_rect):
    """(max-seed rect, min-seed rect or None) of the candidate options, by
    the JAX package's rules: the calibrated pair without `window`; with
    `window`, a window × window square at offsets −anchor .. window − 1 −
    anchor (anchor default min(2, window − 1)) and no min seed unless
    `min_rect` names one."""
    if window is None:
        if anchor is not None:
            raise ValueError(
                "anchor only places an explicit `window` rect; without "
                "`window` the calibrated dual-seed rects are used and anchor "
                "would be ignored")
        return _MAX_RECT, (_MIN_RECT if min_rect == "default" else min_rect)
    if anchor is None:
        anchor = min(2, window - 1)
    lo, hi = -anchor, window - 1 - anchor
    return (lo, hi, lo, hi), (None if min_rect == "default" else min_rect)


def rasterize(warp: torch.Tensor, rgb: torch.Tensor, arap_mask: torch.Tensor,
              window: int | None = None, dilate: int = 3,
              anchor: int | None = None, min_rect: tuple | None = "default",
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-rasterize the warped grid of one problem.

    warp (2, H, W) absolute warped positions; rgb (3, H, W) float colours;
    arap_mask (H, W), 0 = object. The candidate quads: see ``_rects``;
    `min_rect` (y0, y1, x0, x1) inclusive offsets around the min seed, None
    for no second seed, "default" for the calibrated rect where `window` is
    not given. Returns (warped rgb (3, H, W) float holding whole uint8
    values, warped mask (H, W) float ∈ {0, 255})."""
    max_rect, min_rect = _rects(window, anchor, min_rect)
    H, W = arap_mask.shape
    dev = warp.device
    m = arap_mask == 0
    # a quad is drawable iff its 4 corners are unmasked
    m4 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    m4[: H - 1, : W - 1] = m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]
    grid = make_grid(H, W, dev, dtype=warp.dtype)
    gx, gy = grid[0], grid[1]
    wx_flat, wy_flat = warp[0].reshape(-1), warp[1].reshape(-1)
    m4f = m4.reshape(-1)

    best_prio = torch.full((H, W), -1, dtype=torch.int64, device=dev)
    best_w = torch.zeros((3, H, W), dtype=warp.dtype, device=dev)
    best_c = torch.zeros((3, H, W), dtype=torch.int64, device=dev)
    covered = torch.zeros((H, W), dtype=torch.bool, device=dev)

    def run_rect(seeds, empty, rect):
        nonlocal best_prio, best_w, best_c, covered
        y0, y1, x0, x1 = rect
        n_cols = x1 - x0 + 1
        has_seed = seeds != empty
        sy0 = torch.div(seeds, W, rounding_mode="floor") + y0
        sx0 = torch.remainder(seeds, W) + x0

        def gather_row(cy):
            yy = torch.clamp(cy, 0, H - 1)
            row = []
            for cx in range(n_cols + 1):
                idx = yy * W + torch.clamp(sx0 + cx, 0, W - 1)
                row.append((wx_flat[idx], wy_flat[idx], idx))
            return row

        row0 = gather_row(sy0)
        for oy in range(y1 - y0 + 1):
            qyy = sy0 + oy
            # adjacent candidate rows share a corner row: carry it
            row1 = gather_row(qyy + 1)
            for ox in range(n_cols):
                c00, c01 = row0[ox], row0[ox + 1]
                c10, c11 = row1[ox], row1[ox + 1]
                qxx = sx0 + ox
                in_range = (has_seed & (qyy >= 0) & (qyy < H - 1)
                            & (qxx >= 0) & (qxx < W - 1))
                qvalid = in_range & m4f[
                    torch.clamp(qyy, 0, H - 1) * W + torch.clamp(qxx, 0, W - 1)
                ]
                qprio = (qyy * (W - 1) + qxx) * 2
                for t, (A, B, C) in enumerate(((c00, c01, c10),
                                               (c10, c01, c11))):
                    ok, w0, w1, w2 = _lk_accept(A[0], A[1], B[0], B[1],
                                                C[0], C[1], gx, gy)
                    ok = ok & qvalid
                    prio = qprio + t
                    take = ok & (prio > best_prio)
                    best_prio = torch.where(take, prio, best_prio)
                    best_w = torch.where(take, torch.stack([w0, w1, w2]), best_w)
                    best_c = torch.where(take, torch.stack([A[2], B[2], C[2]]),
                                         best_c)
                    covered = covered | ok
            row0 = row1

    run_rect(_seed_map(warp, m4, dilate, "max"), -1, max_rect)
    if min_rect is not None:
        run_rect(_seed_map(warp, m4, dilate, "min"), _MIN_EMPTY,
                 tuple(min_rect))

    rflat = rgb.reshape(rgb.shape[0], -1)
    col = (rflat[:, best_c[0]] * best_w[0] + rflat[:, best_c[1]] * best_w[1]
           + rflat[:, best_c[2]] * best_w[2])
    wrgb = torch.floor(torch.clamp(col, 0.0, 255.0))  # uint8 C-cast truncation
    wrgb = torch.where(best_prio[None] >= 0, wrgb, 0.0)
    wmask = torch.where(covered, 255.0, 0.0).to(warp.dtype)
    return wrgb, wmask


class _RasterGraph:
    """``rasterize`` (default options) captured as a CUDA graph on static
    input buffers; its outputs are static buffers too."""

    def __init__(self, warp, rgb, arap_mask):
        self.inputs = tuple(torch.empty_like(t) for t in (warp, rgb, arap_mask))
        self.graph, self.out = graphs.capture(
            warp.device, lambda: rasterize(*self.inputs))

    def __call__(self, *args):
        for static, t in zip(self.inputs, args):
            static.copy_(t)
        self.graph.replay()
        return self.out


def rasterize_replayed(warp: torch.Tensor, rgb: torch.Tensor,
                       arap_mask: torch.Tensor):
    """``rasterize`` with its default options. On CUDA tensors the call runs
    as ``graphs.engage`` says for the three operands' layout: eagerly the
    first time the thread meets it, captured the second (stage "raster
    graph capture"), replayed from then on (stage "raster graph replay":
    the copies into the static inputs and the replay). A replay returns the
    graph's static outputs, which the next call of the same layout
    overwrites in stream order: read or copy them before that."""
    if not warp.is_cuda:
        return rasterize(warp, rgb, arap_mask)
    registry = graphs.registry("raster")
    key = tuple(graphs.layout(t) for t in (warp, rgb, arap_mask))
    how = graphs.engage(registry, key)
    if how == "eager":
        return rasterize(warp, rgb, arap_mask)
    timer = profiling.TIMER
    if how == "capture":
        with timer.stage("raster graph capture"):
            registry[key] = _RasterGraph(warp, rgb, arap_mask)
    with timer.stage("raster graph replay"):
        return registry[key](warp, rgb, arap_mask)


def rasterize_flow(flow: torch.Tensor, rgb: torch.Tensor,
                   arap_mask: torch.Tensor, window: int | None = None,
                   dilate: int = 3, anchor: int | None = None,
                   min_rect: tuple | None = "default"):
    """Rasterize from a flow field (2, H, W): warp = flow + grid."""
    return rasterize(make_warp(flow), rgb, arap_mask, window=window,
                     dilate=dilate, anchor=anchor, min_rect=min_rect)
