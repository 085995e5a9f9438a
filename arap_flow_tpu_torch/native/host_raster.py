"""Reference-exact forward quad rasterization (host, vectorised numpy; a
copy of the JAX package's native/host_raster.py).

The plain version of the native library's ``raster_warp`` (C++,
``native/runtime.rasterize_warp``): the tests hold the two bitwise equal,
and nothing on the pipeline's path calls this module's rasterizer.

Semantics replicated from the reference CPU rasterizers
(ARAP/warping/src/main.cpp:110-225 and CombinedSolver.h:248-342):

- every grid quad (x, y), x ∈ [0, W−2], y ∈ [0, H−2], whose four corners are all
  unmasked (mask == 0), emits two triangles of its warped corner positions:
  T1 = (p00, p01, p10), T2 = (p10, p01, p11);
- each pixel in a triangle's bbox is tested with the LK edge-function test
  (accept iff all normalised edge functions ≥ 0 and not backfacing) and painted
  with the barycentric-interpolated color, truncated to uint8 (mLib vec3uc cast);
- quads are drawn in row-major order, T1 before T2 — later writes win;
- the warped mask is 255 on every covered pixel, 0 elsewhere.

Instead of the reference's sequential pixel loops, this implementation runs an
offset-scan: for each (dy, dx) offset within the largest triangle bbox, every
triangle's candidate pixel is tested simultaneously and resolved with a single
scatter-max of a (draw-priority << 24 | packed-RGB) key — bit-identical
last-write-wins without any sequential loop.
"""

from __future__ import annotations

import numpy as np


def _lk_coverage(P0, P1, P2, sx, sy):
    """Vectorised PointInTriangleLK (warping/src/main.cpp:68-104).

    P* are (N, 2) float32 triangle corners; sx, sy are (N,) sample coords.
    Returns (accept (N,), w0, w1, w2 barycentric weights).
    """
    X0 = P0[:, 0] - sx
    X1 = P1[:, 0] - sx
    X2 = P2[:, 0] - sx
    Y0 = P0[:, 1] - sy
    Y1 = P1[:, 1] - sy
    Y2 = P2[:, 1] - sy
    d01 = X0 * Y1 - Y0 * X1
    d12 = X1 * Y2 - Y1 * X2
    d20 = X2 * Y0 - Y2 * X0
    backfacing = (d01 < 0) & (d12 < 0) & (d20 < 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / (d01 + d12 + d20)
        n01 = d01 * inv
        n12 = d12 * inv
        n20 = d20 * inv
    accept = (~backfacing) & (n01 >= 0) & (n12 >= 0) & (n20 >= 0)
    return accept, n12, n20, n01


def _triangles(warp: np.ndarray, arap_mask: np.ndarray):
    """Corner positions, colors-index corners, priorities and validity for all
    2·(H−1)·(W−1) triangles in draw order."""
    H, W = arap_mask.shape
    m = arap_mask == 0
    qvalid = (m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]).ravel()

    p00 = warp[:-1, :-1].reshape(-1, 2)
    p01 = warp[:-1, 1:].reshape(-1, 2)
    p10 = warp[1:, :-1].reshape(-1, 2)
    p11 = warp[1:, 1:].reshape(-1, 2)

    # triangle k = 2*q + t, t ∈ {0: (p00,p01,p10), 1: (p10,p01,p11)}
    P0 = np.concatenate([p00[:, None], p10[:, None]], 1).reshape(-1, 2)
    P1 = np.concatenate([p01[:, None], p01[:, None]], 1).reshape(-1, 2)
    P2 = np.concatenate([p10[:, None], p11[:, None]], 1).reshape(-1, 2)
    valid = np.repeat(qvalid, 2)
    prio = np.arange(valid.size, dtype=np.int64)  # == draw order
    return P0, P1, P2, valid, prio


def _corner_colors(rgb: np.ndarray):
    c00 = rgb[:-1, :-1].reshape(-1, 3).astype(np.float32)
    c01 = rgb[:-1, 1:].reshape(-1, 3).astype(np.float32)
    c10 = rgb[1:, :-1].reshape(-1, 3).astype(np.float32)
    c11 = rgb[1:, 1:].reshape(-1, 3).astype(np.float32)
    C0 = np.concatenate([c00[:, None], c10[:, None]], 1).reshape(-1, 3)
    C1 = np.concatenate([c01[:, None], c01[:, None]], 1).reshape(-1, 3)
    C2 = np.concatenate([c10[:, None], c11[:, None]], 1).reshape(-1, 3)
    return C0, C1, C2


def rasterize_warp_exact(
    warp: np.ndarray, rgb: np.ndarray, arap_mask: np.ndarray,
    return_prio: bool = False,
):
    """Rasterize a warped grid into (warped_rgb (H,W,3) u8, warped_mask (H,W) u8).

    warp: (H, W, 2) float32 absolute warped positions (x, y) per pixel.
    rgb:  (H, W, 3) uint8 source colors.
    arap_mask: (H, W); 0 = object (drawn), nonzero = excluded.
    return_prio: also return the (H, W) int64 winning-triangle draw priority
    (−1 where uncovered) — diagnostic for the device-raster window design.
    """
    warp = np.ascontiguousarray(warp, np.float32)
    H, W = arap_mask.shape
    P0, P1, P2, valid, prio = _triangles(warp, arap_mask)
    C0, C1, C2 = _corner_colors(rgb)

    # drop triangles with non-finite corners: a divergent solve's NaN/inf
    # positions cast to int64 give undefined garbage bboxes, and because
    # this vectorized scan loops over the GLOBAL max bbox extent, one bad
    # triangle would stall the whole raster (in the per-triangle C++/
    # reference loop a bad bbox only inflates that one triangle's scan);
    # non-finite corners can never cover a pixel, so dropping them is exact
    finite = (np.isfinite(P0) & np.isfinite(P1) & np.isfinite(P2)).all(axis=1)
    keep = valid & finite
    P0, P1, P2 = P0[keep], P1[keep], P2[keep]
    C0, C1, C2 = C0[keep], C1[keep], C2[keep]
    prio = prio[keep]
    if len(prio) == 0:
        empty = (
            np.zeros((H, W, 3), np.uint8),
            np.zeros((H, W), np.uint8),
        )
        if return_prio:
            return (*empty, np.full((H, W), -1, np.int64))
        return empty

    # bbox loop bounds (floor(min) .. ceil(max) inclusive, main.cpp:123-126)
    bmin = np.floor(np.minimum(np.minimum(P0, P1), P2)).astype(np.int64)
    bmax = np.ceil(np.maximum(np.maximum(P0, P1), P2)).astype(np.int64)
    ext = bmax - bmin
    max_w = int(ext[:, 0].max()) + 1
    max_h = int(ext[:, 1].max()) + 1

    key = np.full(H * W, -1, np.int64)
    covered = np.zeros(H * W, bool)
    for oy in range(max_h):
        for ox in range(max_w):
            sx = bmin[:, 0] + ox
            sy = bmin[:, 1] + oy
            inb = (
                (sx <= bmax[:, 0])
                & (sy <= bmax[:, 1])
                & (sx >= 0)
                & (sx < W)
                & (sy >= 0)
                & (sy < H)
            )
            if not inb.any():
                continue
            acc, w0, w1, w2 = _lk_coverage(
                P0, P1, P2, sx.astype(np.float32), sy.astype(np.float32)
            )
            hit = inb & acc
            if not hit.any():
                continue
            col = (
                C0[hit] * w0[hit, None]
                + C1[hit] * w1[hit, None]
                + C2[hit] * w2[hit, None]
            )
            col_u8 = col.astype(np.uint8)  # C-cast truncation (vec3.h:33-37)
            packed = (
                (prio[hit] << 24)
                | (col_u8[:, 0].astype(np.int64) << 16)
                | (col_u8[:, 1].astype(np.int64) << 8)
                | col_u8[:, 2].astype(np.int64)
            )
            idx = sy[hit] * W + sx[hit]
            np.maximum.at(key, idx, packed)
            covered[idx] = True

    out = np.zeros((H * W, 3), np.uint8)
    won = key >= 0
    out[won, 0] = (key[won] >> 16) & 0xFF
    out[won, 1] = (key[won] >> 8) & 0xFF
    out[won, 2] = key[won] & 0xFF
    wmask = np.where(covered, np.uint8(255), np.uint8(0)).reshape(H, W)
    if return_prio:
        prio_map = np.where(won, key >> 24, np.int64(-1)).reshape(H, W)
        return out.reshape(H, W, 3), wmask, prio_map
    return out.reshape(H, W, 3), wmask


def warp_from_flow(flow_uv: np.ndarray) -> np.ndarray:
    """warpField = flow + grid (warping/src/main.cpp:159-166). flow_uv: (H,W,2)."""
    H, W = flow_uv.shape[:2]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    return np.stack([flow_uv[:, :, 0] + gx, flow_uv[:, :, 1] + gy], axis=-1)
