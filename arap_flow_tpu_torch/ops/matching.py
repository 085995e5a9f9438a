"""Sparse correspondence matching: the coarse-to-fine ZNCC pyramid
(ops/matching.py of the JAX package).

1. grayscale and a 2×2 average-pool pyramid;
2. at the coarsest level, an exhaustive ZNCC search over a window of radius
   ⌈radius / 2^levels⌉, once per affine hypothesis (image 2 resampled by
   M = R_θ·diag(sx, sy) about its centre); a non-identity hypothesis wins a
   pixel only by a margin of 0.1 in score, and its offset is folded back
   into image-2 coordinates;
3. at each finer level the flow is doubled onto the finer grid, image 2 is
   warped by it (bilinear) and a ±refine_radius search refines it
   (`refine_passes` times);
4. on the stride grid, forward-backward consistency and a score threshold,
   then two local-coherence passes on the host, select the matches.

Every rigid search, coarse and refine, goes through
``ops.zncc.zncc_search``: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors. Where the JAX package vmaps over directions and
pairs, the batch dimension is written out: a pair stack of B frames runs as
2·B lanes (forward, backward for each pair), and the coarse level searches
2·B·K planes in one call.

``subpatch=True`` replaces the coarse search by DeepMatching's
split-and-rescore (``_search_subpatch``), in plain torch as the JAX package
computes it outside its Pallas kernel. It materialises (side², H, W)
offset stacks, so above the JAX package's element budget it falls back to
the rigid search; the budget is divided by the hypotheses and the lanes
(1 for ``pyramid_flow``, 2 for ``pyramid_flow_bidir`` and ``match_grid``,
2·B for ``match_grid_multi``) as there, so both packages take the same
search.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling, transfer
from .zncc import box_sum, zncc_search, zscore


def to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) float32 RGB -> (..., H, W) luma."""
    return 0.299 * rgb[..., 0, :, :] + 0.587 * rgb[..., 1, :, :] + (
        0.114 * rgb[..., 2, :, :])


def _avg_pool2(im: torch.Tensor) -> torch.Tensor:
    """2×2 average pool over the last two axes; leading axes batched."""
    H, W = im.shape[-2:]
    H2, W2 = H // 2, W // 2
    lead = im.shape[:-2]
    out = im[..., : H2 * 2, : W2 * 2].reshape(*lead, H2, 2, W2, 2)
    return out.mean((-3, -1))


def _bilinear(plane: torch.Tensor, qx: torch.Tensor,
              qy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of plane (L, H, W) at positions qx, qy (L, ...),
    clamped to the plane; returns (L, ...)."""
    L, H, W = plane.shape
    qx = torch.clamp(qx, 0.0, W - 1.0)
    qy = torch.clamp(qy, 0.0, H - 1.0)
    x0 = torch.floor(qx).to(torch.int64)
    y0 = torch.floor(qy).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = qx - x0
    fy = qy - y0
    flat = plane.reshape(L, H * W)

    def at(iy, ix):
        return torch.gather(flat, 1, (iy * W + ix).reshape(L, -1)).reshape(
            iy.shape)

    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x1) * fx * (1 - fy)
        + at(y1, x0) * (1 - fx) * fy
        + at(y1, x1) * fx * fy
    )


def _grid(H: int, W: int, device):
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return gx, gy


def _up2(a: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """×2 nearest upsample over the last two axes, cropped or edge-padded
    to (H, W)."""
    a = a.repeat_interleave(2, -2).repeat_interleave(2, -1)[..., :H, :W]
    if a.shape[-2:] != (H, W):
        a = F.pad(a, (0, W - a.shape[-1], 0, H - a.shape[-2]),
                  mode="replicate")
    return a


def _hypotheses(rotations) -> tuple:
    """Hypotheses as affine triples (θ, sx, sy); a plain angle is (θ, 1, 1)."""
    return tuple(
        (float(h), 1.0, 1.0) if np.isscalar(h) else
        (float(h[0]), float(h[1]), float(h[2]))
        for h in rotations
    )


def zncc_calls(levels: int, refine_passes: int = 1) -> int:
    """zncc_search launches of one pyramid match (any number of lanes) with
    the rigid coarse search: the coarse bank, then refine_passes at each
    finer level. A subpatch coarse search within its budget launches the
    refine searches only."""
    return 1 + levels * refine_passes


# elements of the offset stacks the JAX package materialises at once
# (n_off·H·W) in its vectorised coarse search (matching.py:138)
_SEARCH_VEC_BUDGET = 48 * 1024 * 1024


def subpatch_fits(H: int, W: int, radius: int, budget_div: int = 1) -> bool:
    """Whether the split-and-rescore search of an (H, W) plane at `radius`
    stays within its budget: it holds several (side², H, W) stacks at once,
    so a third of the vectorised search's budget, shared by `budget_div`
    concurrent planes (hypotheses × lanes)."""
    side = 2 * radius + 1
    return side * side * H * W <= _SEARCH_VEC_BUDGET // (3 * max(1, budget_div))


def subpatch_scores(g1: torch.Tensor, g2: torch.Tensor, radius: int,
                    patch: int) -> torch.Tensor:
    """The split-and-rescore scores of raw (H, W) planes at every offset,
    (side², H, W) in raster order from (−r, −r) (DeepMatching's bottom-up
    aggregation, one level):

      child(o, p)  = ZNCC of the half-size (k/2) sub-patch at p, offset o
      relax(o, p)  = max over |o' − o|∞ ≤ 1 of child(o', p)   (−inf beyond
                     the offset window)
      parent(o, p) = ¼ Σ_{δ ∈ {±k/4}²} relax(o, p + δ)        (zero beyond
                     the plane)

    Children are z-scored at their own k/2 scale."""
    H, W = g1.shape
    kc = max(2, patch // 2)
    h = max(1, kc // 2)  # a child centre's offset from the parent centre
    side = 2 * radius + 1
    z = zscore(torch.stack([g1, g2]), kc)
    z2p = F.pad(z[1], (radius, radius, radius, radius))
    shifts = z2p.unfold(0, H, 1).unfold(1, W, 1)  # (side, side, H, W)
    child = box_sum(z[0] * shifts, kc) / float(kc * kc)
    cp = F.pad(child, (0, 0, 0, 0, 1, 1, 1, 1), value=-torch.inf)
    relax = child
    for oy in range(3):
        for ox in range(3):
            if oy != 1 or ox != 1:
                relax = torch.maximum(relax,
                                      cp[oy : oy + side, ox : ox + side])
    rp = F.pad(relax, (h, h, h, h))
    return 0.25 * (
        rp[:, :, 0:H, 0:W]
        + rp[:, :, 0:H, 2 * h : 2 * h + W]
        + rp[:, :, 2 * h : 2 * h + H, 0:W]
        + rp[:, :, 2 * h : 2 * h + H, 2 * h : 2 * h + W]
    ).reshape(side * side, H, W)


def _search_subpatch(g1: torch.Tensor, g2: torch.Tensor, radius: int,
                     patch: int, budget_div: int = 1):
    """DeepMatching-style split-and-rescore search of raw (H, W) planes
    (``subpatch_scores``). Returns (du, dv, score) (H, W): per pixel the
    first offset in raster order with the highest score. Where the offset
    stacks exceed the budget (``subpatch_fits``), the rigid search
    (``zncc_search``) instead."""
    H, W = g1.shape
    if not subpatch_fits(H, W, radius, budget_div):
        return zncc_search(g1.contiguous(), g2.contiguous(), radius, patch)
    parent = subpatch_scores(g1, g2, radius, patch)
    best_idx = torch.argmax(parent, dim=0)  # the first maximum
    best = torch.take_along_dim(parent, best_idx[None], dim=0)[0]
    side = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=g1.device)
    return offs[best_idx % side], offs[best_idx // side], best


def _pyramid_flow(g1: torch.Tensor, g2: torch.Tensor, radius: int = 100,
                  patch: int = 12, levels: int = 3, refine_radius: int = 2,
                  rotations: tuple = (0.0,), refine_passes: int = 1,
                  subpatch: bool = False):
    """Dense coarse-to-fine NCC flow from each lane of g1 (L, H, W) into the
    same lane of g2. Returns (flow (L, 2, H, W), score (L, H, W))."""
    L = g1.shape[0]
    dev = g1.device
    pyr1, pyr2 = [g1], [g2]
    for _ in range(levels):
        pyr1.append(_avg_pool2(pyr1[-1]))
        pyr2.append(_avg_pool2(pyr2[-1]))

    coarse_r = max(2, int(np.ceil(radius / (2 ** levels))))
    Hc, Wc = pyr1[-1].shape[-2:]
    ccy, ccx = (Hc - 1) / 2.0, (Wc - 1) / 2.0
    gxc, gyc = _grid(Hc, Wc, dev)

    hyps = _hypotheses(rotations)
    K = len(hyps)
    Ms = np.array([
        [[np.cos(th) * sx, -np.sin(th) * sy], [np.sin(th) * sx, np.cos(th) * sy]]
        for th, sx, sy in hyps
    ])
    gx_np, gy_np = np.meshgrid(np.arange(Wc, dtype=np.float64),
                               np.arange(Hc, dtype=np.float64))
    qx = np.stack([m[0, 0] * (gx_np - ccx) + m[0, 1] * (gy_np - ccy) + ccx
                   for m in Ms])
    qy = np.stack([m[1, 0] * (gx_np - ccx) + m[1, 1] * (gy_np - ccy) + ccy
                   for m in Ms])

    def lanes(a):
        return transfer.upload(np.asarray(a, np.float32), dev).expand(
            L, *a.shape)

    g2r = _bilinear(pyr2[-1], lanes(qx), lanes(qy))  # (L, K, Hc, Wc)
    if subpatch and subpatch_fits(Hc, Wc, coarse_r, K * L):
        # one plane at a time: the budget counts every lane's stacks, but
        # the planes need not be live together
        found = [_search_subpatch(pyr1[-1][i], g2r[i, k], coarse_r, patch,
                                  K * L)
                 for i in range(L) for k in range(K)]
        du, dv, sc = (torch.stack([f[j] for f in found]).reshape(L, K, Hc, Wc)
                      for j in range(3))
    else:
        du, dv, sc = (t.reshape(L, K, Hc, Wc) for t in zncc_search(
            pyr1[-1].contiguous(), g2r.reshape(L * K, Hc, Wc).contiguous(),
            coarse_r, patch))

    def m(i, j):
        return transfer.upload(np.asarray(Ms[:, i, j], np.float32),
                               dev)[:, None, None]

    px = gxc + du
    py = gyc + dv
    ur_all = m(0, 0) * (px - ccx) + m(0, 1) * (py - ccy) + ccx - gxc
    vr_all = m(1, 0) * (px - ccx) + m(1, 1) * (py - ccy) + ccy - gyc
    # a non-identity hypothesis must beat the incumbent by a clear margin;
    # ties go to the earlier hypothesis (identity first by convention)
    u, v, score = ur_all[:, 0], vr_all[:, 0], sc[:, 0]
    for r, (theta, sx_, sy_) in enumerate(hyps):
        if r == 0:
            continue
        ident = theta == 0.0 and sx_ == 1.0 and sy_ == 1.0
        take = sc[:, r] > score + (0.0 if ident else 0.1)
        u = torch.where(take, ur_all[:, r], u)
        v = torch.where(take, vr_all[:, r], v)
        score = torch.where(take, sc[:, r], score)

    uv = torch.stack([u, v], dim=1)
    for lvl in range(levels - 1, -1, -1):
        H, W = pyr1[lvl].shape[-2:]
        uv = _up2(uv, H, W) * 2.0
        if refine_passes == 0:
            # no refine search overwrites the score: carry it up with the flow
            score = _up2(score, H, W)
        gx, gy = _grid(H, W, dev)
        for _ in range(refine_passes):
            w2 = _bilinear(pyr2[lvl], gx + uv[:, 0], gy + uv[:, 1])
            du, dv, score = zncc_search(pyr1[lvl].contiguous(),
                                        w2.contiguous(), refine_radius, patch)
            uv = uv + torch.stack([du, dv], dim=1)
    return uv, score


def pyramid_flow(g1: torch.Tensor, g2: torch.Tensor, radius: int = 100,
                 patch: int = 12, levels: int = 3, refine_radius: int = 2,
                 rotations: tuple = (0.0,), refine_passes: int = 1,
                 subpatch: bool = False):
    """Dense NCC flow from g1 into g2, each (H, W) float32 grayscale.
    Returns (flow (2, H, W), score (H, W))."""
    uv, score = _pyramid_flow(g1[None], g2[None], radius, patch, levels,
                              refine_radius, rotations, refine_passes,
                              subpatch)
    return uv[0], score[0]


def pyramid_flow_bidir(g1: torch.Tensor, g2: torch.Tensor, radius: int = 100,
                       patch: int = 12, levels: int = 3, refine_radius: int = 2,
                       rotations: tuple = (0.0,), refine_passes: int = 1,
                       subpatch: bool = False):
    """Forward (g1 -> g2) and backward (g2 -> g1) flow as two lanes of one
    pyramid. Returns (flows (2, 2, H, W), scores (2, H, W)). `rotations`
    must be a symmetric set (the backward direction sees the inverse
    rotation)."""
    return _pyramid_flow(torch.stack([g1, g2]), torch.stack([g2, g1]), radius,
                         patch, levels, refine_radius, rotations,
                         refine_passes, subpatch)


# default rotation-hypothesis set: ±15°/±30° coarse seeds, symmetric
DEFAULT_ROTATIONS = (0.0, 0.2618, -0.2618, 0.5236, -0.5236)

# extended bank for extreme deformation: rotations plus isotropic and
# anisotropic scale seeds covering ~±50% local stretch, inverse-closed so
# the backward direction sees the matching inverses. Opt-in.
STRETCH_HYPOTHESES = DEFAULT_ROTATIONS + (
    (0.0, 1.25, 1.25), (0.0, 0.8, 0.8),
    (0.0, 1.5, 1.5), (0.0, 0.667, 0.667),
    (0.0, 1.4, 1.0), (0.0, 0.714, 1.0),
    (0.0, 1.0, 1.4), (0.0, 1.0, 0.714),
)


def _device_grid_select(fwd, bwd, score, stride: int):
    """Stride-grid subsample and forward-backward error on the device, for
    B pairs: fwd, bwd (B, 2, H, W), score (B, H, W). Returns (u, v, score,
    fb_err), each (B, gh, gw)."""
    B, H, W = score.shape
    s2 = stride // 2
    u = fwd[:, 0, s2::stride, s2::stride]
    v = fwd[:, 1, s2::stride, s2::stride]
    sg = score[:, s2::stride, s2::stride]
    dev = score.device
    xs = torch.arange(s2, W, stride, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(s2, H, stride, dtype=torch.float32, device=dev)[:, None]
    xt = torch.clamp(torch.round(xs + u), 0, W - 1).to(torch.int64)
    yt = torch.clamp(torch.round(ys + v), 0, H - 1).to(torch.int64)
    idx = (yt * W + xt).reshape(B, -1)

    def at(plane):
        return torch.gather(plane.reshape(B, H * W), 1, idx).reshape(u.shape)

    fb = torch.hypot(u + at(bwd[:, 0]), v + at(bwd[:, 1]))
    return u, v, sg, fb


def match_grid_multi(rgb1s: torch.Tensor, rgb2s: torch.Tensor, stride: int = 4,
                     radius: int = 100, patch: int = 12, levels: int = 3,
                     refine_radius: int = 2,
                     rotations: tuple = DEFAULT_ROTATIONS,
                     refine_passes: int = 1, downscale: int = 1,
                     subpatch: bool = False):
    """Bidirectional pyramid matching and grid selection for a stack of B
    same-shaped pairs, (B, 3, H, W) uint8 or float: one zncc_search call per
    search level for all 2·B lanes. Returns (u, v, score, fb_err), each
    (B, gh, gw), on the frames' device.

    `downscale` (power of 2): the whole match runs on a 2×2-average-pooled
    image; radius, stride, patch, levels and the returned planes are all in
    downsampled units."""
    B = rgb1s.shape[0]
    g1 = to_gray(rgb1s.to(torch.float32))
    g2 = to_gray(rgb2s.to(torch.float32))
    # lanes 2i and 2i+1: pair i forward (g1 -> g2) and backward (g2 -> g1)
    a = torch.stack([g1, g2], dim=1).flatten(0, 1)
    b = torch.stack([g2, g1], dim=1).flatten(0, 1)
    ds = downscale
    while ds > 1:
        a = _avg_pool2(a)
        b = _avg_pool2(b)
        ds //= 2
    flows, scores = _pyramid_flow(a, b, radius, patch, levels, refine_radius,
                                  rotations, refine_passes, subpatch)
    return _device_grid_select(flows[0::2], flows[1::2], scores[0::2], stride)


def match_grid(rgb1: torch.Tensor, rgb2: torch.Tensor, stride: int = 4,
               radius: int = 100, patch: int = 12, levels: int = 3,
               refine_radius: int = 2, rotations: tuple = DEFAULT_ROTATIONS,
               refine_passes: int = 1, downscale: int = 1,
               subpatch: bool = False):
    """match_grid_multi for one (3, H, W) pair; returns (gh, gw) planes."""
    out = match_grid_multi(rgb1[None], rgb2[None], stride, radius, patch,
                           levels, refine_radius, rotations, refine_passes,
                           downscale, subpatch)
    return tuple(t[0] for t in out)


def match_fields(rgb1: torch.Tensor, rgb2: torch.Tensor, radius: int = 100,
                 patch: int = 12, levels: int = 3, refine_radius: int = 2,
                 rotations: tuple = DEFAULT_ROTATIONS, refine_passes: int = 1,
                 subpatch: bool = False):
    """Gray conversion and the bidirectional pyramid flow of one (3, H, W)
    float32 RGB pair: (flows (2, 2, H, W), scores (2, H, W))."""
    return pyramid_flow_bidir(to_gray(rgb1), to_gray(rgb2), radius=radius,
                              patch=patch, levels=levels,
                              refine_radius=refine_radius, rotations=rotations,
                              refine_passes=refine_passes, subpatch=subpatch)


def _coherence_keep(keep_grid, u_grid, v_grid, tol=4.0, rel=0.2, rad=3,
                    min_nbrs=3):
    """Local-coherence outlier rejection on the stride grid: a match whose
    displacement deviates from the median of its (2·rad+1)² grid window by
    more than tol + rel·|median| is dropped; cells with fewer than min_nbrs
    valid neighbours are kept."""
    gh, gw = keep_grid.shape
    uu = np.where(keep_grid, u_grid, np.nan)
    vv = np.where(keep_grid, v_grid, np.nan)
    stacks_u, stacks_v = [], []
    pad_u = np.pad(uu, rad, constant_values=np.nan)
    pad_v = np.pad(vv, rad, constant_values=np.nan)
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            if dy == 0 and dx == 0:
                continue
            stacks_u.append(pad_u[rad + dy : rad + dy + gh,
                                  rad + dx : rad + dx + gw])
            stacks_v.append(pad_v[rad + dy : rad + dy + gh,
                                  rad + dx : rad + dx + gw])
    su = np.stack(stacks_u)
    sv = np.stack(stacks_v)
    nbrs = np.isfinite(su).sum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN windows
        med_u = np.nanmedian(su, axis=0)
        med_v = np.nanmedian(sv, axis=0)
    dev = np.hypot(uu - med_u, vv - med_v)
    lim = tol + rel * np.hypot(med_u, med_v)
    ok = (nbrs < min_nbrs) | (dev <= lim)  # dev <= lim is False on NaN
    return keep_grid & ok


def _knn_coherence(xs, ys, u, v, keep, k=6, tol=4.0, rel=0.2):
    """Exact k-nearest-neighbour coherence pass for sparse match sets (the
    deviation rule of _coherence_keep); O(n²) on the kept set."""
    idx = np.where(keep)[0]
    n = len(idx)
    if n <= k:
        return keep
    sx, sy = xs[idx].astype(np.float64), ys[idx].astype(np.float64)
    du, dv = u[idx], v[idx]
    d2 = (sx[:, None] - sx[None, :]) ** 2 + (sy[:, None] - sy[None, :]) ** 2
    np.fill_diagonal(d2, np.inf)
    nbr = np.argpartition(d2, k, axis=1)[:, :k]
    med_u = np.median(du[nbr], axis=1)
    med_v = np.median(dv[nbr], axis=1)
    dev = np.hypot(du - med_u, dv - med_v)
    ok = dev <= tol + rel * np.hypot(med_u, med_v)
    out = keep.copy()
    out[idx[~ok]] = False
    return out


def _select_from_grids(u, v, sc, fb_err, H, W, stride, fb_threshold,
                       score_threshold, radius, coherence: bool = True,
                       off: int | None = None, step: int | None = None,
                       roi=None):
    """Host selection from stride-grid planes (gh, gw): thresholds, the
    region of interest, then two local-coherence passes. `off`/`step` map a
    grid cell to full-resolution pixels (x = off + col·step; the defaults
    are the stride grid's). Returns (N, 5) float32 rows x1 y1 x2 y2 score."""
    gh, gw = u.shape
    if off is None:
        off = stride // 2
    if step is None:
        step = stride
    ys, xs = np.mgrid[0:gh, 0:gw]
    ys = (ys * step + off).ravel()
    xs = (xs * step + off).ravel()
    u, v, sc, fb_err = (a.ravel() for a in (u, v, sc, fb_err))
    x2 = xs + u
    y2 = ys + v
    keep = (
        (fb_err < fb_threshold)
        & (sc >= score_threshold)
        & (x2 >= 0) & (x2 < W) & (y2 >= 0) & (y2 < H)
        & (np.hypot(u, v) <= radius)
    )
    if roi is not None:
        keep &= np.asarray(roi)[ys, xs] != 0
    if coherence:
        if keep.sum() <= 4000:
            # a sparse set: a fixed grid window around an isolated match
            # holds too few neighbours to judge it, so use exact k-NN
            for _ in range(2):
                keep = _knn_coherence(xs, ys, u, v, keep)
        else:
            kg = keep.reshape(gh, gw)
            ug = u.reshape(gh, gw)
            vg = v.reshape(gh, gw)
            for _ in range(2):
                kg = _coherence_keep(kg, ug, vg)
            keep = kg.ravel()
    return np.stack(
        [xs[keep], ys[keep], np.round(x2[keep]), np.round(y2[keep]), sc[keep]],
        axis=1,
    ).astype(np.float32)


def _select_matches(fwd, bwd, score, H, W, stride, fb_threshold,
                    score_threshold, radius, coherence: bool = True):
    """Host selection from dense numpy fields: fwd, bwd (2, H, W), score
    (H, W). The stride grid's forward-backward error, then
    _select_from_grids."""
    s2 = stride // 2
    u = fwd[0, s2::stride, s2::stride]
    v = fwd[1, s2::stride, s2::stride]
    sc = score[s2::stride, s2::stride]
    xs = np.arange(s2, W, stride, dtype=np.float64)[None, :]
    ys = np.arange(s2, H, stride, dtype=np.float64)[:, None]
    xt = np.clip(np.round(xs + u).astype(int), 0, W - 1)
    yt = np.clip(np.round(ys + v).astype(int), 0, H - 1)
    fb_err = np.hypot(u + bwd[0][yt, xt], v + bwd[1][yt, xt])
    return _select_from_grids(u, v, sc, fb_err, H, W, stride, fb_threshold,
                              score_threshold, radius, coherence)


def clamp_match_params(
    H: int, W: int, radius: int = 100, patch: int = 12, levels: int = 3
) -> tuple[int, int]:
    """Frame-size clamps applied before every match: keep the coarsest
    pyramid level at least ~3 patches across and the search radius within
    the frame. Returns (radius, levels)."""
    min_dim = min(H, W)
    levels = max(0, min(levels, int(np.floor(np.log2(min_dim / (3 * patch))))))
    return min(radius, min_dim), levels


def _frames(rgbs, device) -> torch.Tensor:
    """(B, H, W, 3) uint8 host frames -> (B, 3, H, W) uint8 on `device`."""
    return transfer.upload(np.ascontiguousarray(
        np.stack(rgbs).transpose(0, 3, 1, 2)), device)


def match_images_dispatch_multi(
    rgb_pairs: list, radius: int = 100, stride: int = 4, patch: int = 12,
    levels: int = 3, rotations: tuple = None, refine_passes: int = 1,
    downscale: int = 1, subpatch: bool = False, *, device,
) -> list:
    """Enqueue the matcher for a stack of same-shaped (rgb1, rgb2) uint8
    (H, W, 3) pairs on `device` without waiting for it. Returns one
    match_images_fetch handle per pair; the first fetch copies the whole
    stack's grid planes to the host and the others share them."""
    H_, W_ = rgb_pairs[0][0].shape[:2]
    ds = max(1, int(downscale))
    stride_d = max(1, stride // ds)
    rad_d, levels = clamp_match_params(
        H_ // ds, W_ // ds, int(np.ceil(radius / ds)), patch, levels
    )
    if rotations is None:
        rotations = DEFAULT_ROTATIONS
    grids = match_grid_multi(
        _frames([a for a, _ in rgb_pairs], device),
        _frames([b for _, b in rgb_pairs], device),
        stride=stride_d, radius=rad_d, patch=patch, levels=levels,
        rotations=rotations, refine_passes=refine_passes, downscale=ds,
        subpatch=subpatch,
    )
    shared = _SharedGrids(grids, transfer.mark(device))
    return [((shared, i), H_, W_, stride, stride_d, ds, radius)
            for i in range(len(rgb_pairs))]


def match_images_dispatch(
    rgb1, rgb2, radius: int = 100, stride: int = 4, patch: int = 12,
    levels: int = 3, rotations: tuple = None, refine_passes: int = 1,
    downscale: int = 1, subpatch: bool = False, *, device,
):
    """Enqueue the matcher for one pair (match_images_dispatch_multi with
    one pair); returns its match_images_fetch handle."""
    return match_images_dispatch_multi(
        [(rgb1, rgb2)], radius=radius, stride=stride, patch=patch,
        levels=levels, rotations=rotations, refine_passes=refine_passes,
        downscale=downscale, subpatch=subpatch, device=device)[0]


class _SharedGrids:
    """A pair stack's grid planes: copied to the host once, on first use.
    The copy waits for the matcher's own launches only (`ready`, recorded
    after them; ``utils.transfer.fetch``), not for work queued later, such
    as the previous chunk's solves."""

    def __init__(self, grids, ready):
        self._grids = grids
        self._ready = ready
        self._host = None

    def pair(self, i: int):
        if self._host is None:
            self._host = tuple(transfer.fetch(self._grids, self._ready))
            self._grids = self._ready = None
        return tuple(a[i] for a in self._host)


def match_images_fetch(handle, fb_threshold: float = 1.5,
                       score_threshold: float = 0.3,
                       roi_mask=None) -> np.ndarray:
    """Copy a dispatched pair's grid planes to the host (waiting for the
    device) and select its matches. roi_mask (optional (H, W), nonzero = of
    interest) restricts the selection before the coherence passes. Stages
    "matching wait" (the copy, behind whatever the device runs before the
    searches) and "matching select" (the host selection)."""
    (shared, i), H_, W_, stride, stride_d, ds, radius = handle
    timer = profiling.TIMER
    with timer.stage("matching wait"):
        u, v, sg, fb = shared.pair(i)
    with timer.stage("matching select"):
        return _select_from_grids(
            u * ds, v * ds, sg, fb * ds, H_, W_, stride,
            fb_threshold * ds, score_threshold, radius,
            off=ds * (stride_d // 2), step=ds * stride_d, roi=roi_mask,
        )


def match_images(
    rgb1: np.ndarray,
    rgb2: np.ndarray,
    radius: int = 100,
    stride: int = 4,
    patch: int = 12,
    levels: int = 3,
    fb_threshold: float = 1.5,
    score_threshold: float = 0.3,
    rotations: tuple = None,
    refine_passes: int = 1,
    downscale: int = 1,
    roi_mask=None,
    subpatch: bool = False,
    *,
    device,
) -> np.ndarray:
    """Sparse matches between two (H, W, 3) uint8 images on `device`.

    Returns (N, 5) float32 rows ``x1 y1 x2 y2 score`` on a stride grid, kept
    where forward-backward consistency < fb_threshold px and NCC ≥
    score_threshold; displacements are bounded by `radius`. `downscale`
    (power of 2) matches on a pooled image and scales displacements back
    (the fb threshold scales with it)."""
    handle = match_images_dispatch(
        rgb1, rgb2, radius=radius, stride=stride, patch=patch, levels=levels,
        rotations=rotations, refine_passes=refine_passes, downscale=downscale,
        subpatch=subpatch, device=device,
    )
    return match_images_fetch(handle, fb_threshold=fb_threshold,
                              score_threshold=score_threshold,
                              roi_mask=roi_mask)


def write_matches(path, matches: np.ndarray) -> None:
    """Write match lines ``x1 y1 x2 y2 score`` (the DeepMatching output
    format the pipeline's matcher-file mode reads)."""
    with open(path, "w") as f:
        for row in matches:
            f.write(
                f"{int(row[0])} {int(row[1])} {int(row[2])} {int(row[3])} "
                f"{row[4]:.4f}\n"
            )


def match_images_batched(
    pairs: list,
    radius: int = 100,
    stride: int = 4,
    patch: int = 12,
    levels: int = 3,
    fb_threshold: float = 1.5,
    score_threshold: float = 0.3,
    rotations: tuple = None,
    refine_passes: int = 1,
    subpatch: bool = False,
    *,
    device,
) -> list:
    """match_images over a list of (rgb1, rgb2) pairs, one pair at a time;
    returns one (N_i, 5) match array per pair. The multi-pair matcher of
    the pipeline is match_images_dispatch_multi."""
    return [
        match_images(r1, r2, radius=radius, stride=stride, patch=patch,
                     levels=levels, fb_threshold=fb_threshold,
                     score_threshold=score_threshold, rotations=rotations,
                     refine_passes=refine_passes, subpatch=subpatch,
                     device=device)
        for r1, r2 in pairs
    ]
