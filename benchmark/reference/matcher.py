"""The plain reference of the matcher: a frozen copy of the port's plain
torch matcher (ZNCC pyramid with the rotation bank, forward-backward and
score gates on the stride grid, two coherence passes on the host) and of
its plain exhaustive ZNCC search, with no kernel. It runs on any torch
device and imports nothing of the program.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F


EPS = 1e-4


# elements of one offset chunk of the plain search's correlation stack
_CHUNK_ELEMS = 1 << 22


def box_sum(im: torch.Tensor, k: int) -> torch.Tensor:
    """k×k box sum over the last two axes, same size, zero padded; window
    [i − k//2, i + k − 1 − k//2]. Accumulates in im's dtype."""
    a = k // 2
    b = k - 1 - a
    x = F.pad(im, (a, b, a, b))
    for dim in (-1, -2):
        c = F.pad(torch.cumsum(x, dim=dim).movedim(dim, -1), (1, 0))
        n = c.shape[-1] - k
        x = (c[..., k : k + n] - c[..., :n]).movedim(-1, dim)
    return x


def zscore(im: torch.Tensor, k: int, eps: float = EPS) -> torch.Tensor:
    """Patch-normalise: subtract the k×k local mean, divide by the local
    standard deviation (variance floored at eps); float32 result."""
    n = float(k * k)
    x = im.to(torch.float64)
    mu = box_sum(x, k) / n
    var = box_sum(x * x, k) / n - mu * mu
    return ((x - mu) / torch.sqrt(torch.clamp(var, min=eps))).to(torch.float32)


def _search(z1: torch.Tensor, z2: torch.Tensor, radius: int,
                 patch: int = 12):
    """Exhaustive NCC search on z-scored planes (N, H, W) (z1 already
    repeated to z2's batch): (du, dv, score) (N, H, W) float32. Offsets are
    evaluated in vectorised chunks; within a chunk argmax takes the first
    maximum and a later chunk must beat the running best strictly."""
    N, H, W = z2.shape
    n = float(patch * patch)
    side = 2 * radius + 1
    dys, dxs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    dys, dxs = dys.ravel(), dxs.ravel()
    z2p = F.pad(z2, (radius, radius, radius, radius))
    dev = z2.device
    best = torch.full((N, H, W), -torch.inf, dtype=torch.float32, device=dev)
    bu = torch.zeros((N, H, W), dtype=torch.float32, device=dev)
    bv = torch.zeros((N, H, W), dtype=torch.float32, device=dev)
    step = max(1, _CHUNK_ELEMS // (N * H * W))
    ar_h = torch.arange(H, device=dev)
    ar_w = torch.arange(W, device=dev)
    for o0 in range(0, side * side, step):
        dy = torch.as_tensor(dys[o0 : o0 + step] + radius, device=dev)
        dx = torch.as_tensor(dxs[o0 : o0 + step] + radius, device=dev)
        rows = (dy[:, None, None] + ar_h[None, :, None])
        cols = (dx[:, None, None] + ar_w[None, None, :])
        shifts = z2p[:, rows, cols]  # (N, C, H, W)
        corr = box_sum(z1[:, None] * shifts, patch) / n
        idx = torch.argmax(corr, dim=1)  # the first maximum in the chunk
        sc = torch.take_along_dim(corr, idx[:, None], dim=1)[:, 0]
        take = sc > best
        best = torch.where(take, sc, best)
        cu = torch.as_tensor(dxs[o0 : o0 + step], dtype=torch.float32,
                             device=dev)[idx]
        cv = torch.as_tensor(dys[o0 : o0 + step], dtype=torch.float32,
                             device=dev)[idx]
        bu = torch.where(take, cu, bu)
        bv = torch.where(take, cv, bv)
    return bu, bv, best


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


def _pyramid_flow(g1: torch.Tensor, g2: torch.Tensor, radius: int = 100,
                  patch: int = 12, levels: int = 3, refine_radius: int = 2,
                  rotations: tuple = (0.0,), refine_passes: int = 1):
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
        return torch.as_tensor(a, dtype=torch.float32, device=dev).expand(
            L, *a.shape)

    g2r = _bilinear(pyr2[-1], lanes(qx), lanes(qy))  # (L, K, Hc, Wc)
    du, dv, sc = (t.reshape(L, K, Hc, Wc) for t in zncc_search_plain(
        pyr1[-1].contiguous(), g2r.reshape(L * K, Hc, Wc).contiguous(),
        coarse_r, patch))

    def m(i, j):
        return torch.as_tensor(Ms[:, i, j], dtype=torch.float32,
                               device=dev)[:, None, None]

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
            du, dv, score = zncc_search_plain(pyr1[lvl].contiguous(),
                                        w2.contiguous(), refine_radius, patch)
            uv = uv + torch.stack([du, dv], dim=1)
    return uv, score


# default rotation-hypothesis set: ±15°/±30° coarse seeds, symmetric
DEFAULT_ROTATIONS = (0.0, 0.2618, -0.2618, 0.5236, -0.5236)


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


def clamp_match_params(
    H: int, W: int, radius: int = 100, patch: int = 12, levels: int = 3
) -> tuple[int, int]:
    """Frame-size clamps applied before every match: keep the coarsest
    pyramid level at least ~3 patches across and the search radius within
    the frame. Returns (radius, levels)."""
    min_dim = min(H, W)
    levels = max(0, min(levels, int(np.floor(np.log2(min_dim / (3 * patch))))))
    return min(radius, min_dim), levels


def zncc_search_plain(p1: torch.Tensor, p2: torch.Tensor, radius: int,
                      patch: int = 12):
    """Exhaustive ZNCC search of p2's planes (N1·G, H, W) against p1's
    (N1, H, W): per pixel the first best offset in dy-major order."""
    z1 = zscore(p1, patch).repeat_interleave(p2.shape[0] // p1.shape[0], 0)
    return _search(z1, zscore(p2, patch), int(radius), patch)


def match_pair(rgb1: np.ndarray, rgb2: np.ndarray, roi: np.ndarray, device,
               radius: int = 100, stride: int = 4, patch: int = 12,
               levels: int = 3, fb_threshold: float = 1.5,
               score_threshold: float = 0.3) -> np.ndarray:
    """Matches (N, 4) int32 x1 y1 x2 y2 of one (H, W, 3) uint8 pair,
    selected inside `roi` (nonzero = of interest): the program's defaults
    at full resolution."""
    H, W = rgb1.shape[:2]
    rad, levels = clamp_match_params(H, W, radius, patch, levels)

    def frames(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(2, 0, 1))).to(device).to(torch.float32)

    g1, g2 = to_gray(frames(rgb1)), to_gray(frames(rgb2))
    flows, scores = _pyramid_flow(torch.stack([g1, g2]),
                                  torch.stack([g2, g1]), rad, patch, levels,
                                  2, DEFAULT_ROTATIONS, 1)
    u, v, sg, fb = (t[0].cpu().numpy() for t in _device_grid_select(
        flows[0::2], flows[1::2], scores[0::2], stride))
    m = _select_from_grids(u, v, sg, fb, H, W, stride, fb_threshold,
                           score_threshold, radius, off=stride // 2,
                           step=stride, roi=roi)
    return m[:, :4].astype(np.int32)
