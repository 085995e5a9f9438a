"""Fused z-score + exhaustive ZNCC offset search (ops/pallas_match.py of the
JAX package): the matcher's kernel.

Three parts:

- ``zncc_search_plain``: the plain torch version, ``_search(_zscore(p1),
  _zscore(p2), r, patch)`` of the JAX matcher on raw planes. Box sums are
  cumulative-sum differences; the z-score accumulates them in float64, so
  the variance of raw 0..255 planes keeps its precision at full frame size.
- ``zncc_search``: the wrapper. A CPU tensor goes to the plain version; a
  CUDA tensor goes to the hand-written kernel in ``csrc/zncc.cu`` (built on
  first use by ``_build``) or raises. There is no fallback between them.
- ``LAUNCHES``: launch counts; the wrapper adds one each time it launches
  the CUDA kernels (one call z-scores and searches the whole batch, with a
  second pass that reduces the splits of the offset range where the
  library splits it to fill the card).

Planes come batched: p1 holds N1 reference planes and p2 N2 = N1·G search
planes; p2's plane b is searched against p1's plane b // G. The result is
(du, dv, score), each (N2, H, W) float32: per pixel the first offset in
dy-major raster order, from −r, whose score beats every earlier one.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ._checks import check_operand

LAUNCHES: dict[str, int] = {"zncc_search": 0}

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


def _as_batch(p1, p2):
    if p1.dim() != p2.dim() or p1.dim() not in (2, 3):
        raise ValueError(f"zncc_search: planes {tuple(p1.shape)} and "
                         f"{tuple(p2.shape)}; expected (H, W) or (N, H, W)")
    if p1.dim() == 2:
        return p1[None], p2[None], True
    if p2.shape[0] % p1.shape[0] or p1.shape[1:] != p2.shape[1:]:
        raise ValueError(f"zncc_search: p2 {tuple(p2.shape)} is not a "
                         f"multiple of p1 {tuple(p1.shape)}")
    return p1, p2, False


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


def zncc_search_plain(p1: torch.Tensor, p2: torch.Tensor, radius: int,
                      patch: int = 12):
    """Plain version of the fused search on raw planes: (H, W) each, or
    p1 (N1, H, W) and p2 (N1·G, H, W). Returns (du, dv, score) shaped
    like p2."""
    p1, p2, single = _as_batch(p1, p2)
    z1 = zscore(p1, patch).repeat_interleave(p2.shape[0] // p1.shape[0], 0)
    out = _search(z1, zscore(p2, patch), int(radius), patch)
    return tuple(t[0] for t in out) if single else out


@functools.cache
def _splits(lib, N2: int, H: int, W: int, radius: int, device) -> int:
    """How many dy ranges the library splits this search into (asked once
    per shape and device)."""
    n = lib.zncc_search_splits(N2, H, W, radius)
    if n < 0:
        _raise_on(lib, -n, radius)
    return n


def _raise_on(lib, err: int, radius: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"zncc_search: CUDA error {err}: "
            f"{lib.zncc_error_string(err).decode()} (radius {radius})")


def zncc_search(p1: torch.Tensor, p2: torch.Tensor, radius: int,
                patch: int = 12):
    """Fused z-score + ZNCC search (see ``zncc_search_plain`` for the
    arguments). CPU tensors run the plain version; CUDA tensors run the
    CUDA kernel on the current stream, without synchronising."""
    if p1.device.type == "cpu":
        return zncc_search_plain(p1, p2, radius, patch)
    if p1.device.type != "cuda":
        raise ValueError(f"zncc_search: no kernel for device {p1.device}")
    if patch != 12:
        raise ValueError(f"zncc_search: the kernel's patch is 12, not {patch}")
    from .. import _build

    b1, b2, single = _as_batch(p1, p2)
    dev = p1.device
    check_operand("zncc_search", "p1", b1, dev)
    check_operand("zncc_search", "p2", b2, dev)
    N1, H, W = b1.shape
    N2 = b2.shape[0]
    lib = _build.load("zncc")
    with torch.cuda.device(dev):
        splits = _splits(lib, N2, H, W, int(radius), dev)
        du, dv, sc = torch.empty((3, N2, H, W), dtype=torch.float32,
                                 device=dev)
        # z1, z2, then the per-split (score, offset index) pairs when the
        # dy range is split
        scratch = torch.empty(
            (N1 + N2 * (1 + (2 * splits if splits > 1 else 0))) * H * W,
            dtype=torch.float32, device=dev)
        z1 = scratch.data_ptr()
        z2 = z1 + 4 * N1 * H * W
        part = z2 + 4 * N2 * H * W if splits > 1 else 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zncc_search_f32(
            *(ctypes.c_void_p(ptr) for ptr in (
                b1.data_ptr(), b2.data_ptr(), z1, z2, du.data_ptr(),
                dv.data_ptr(), sc.data_ptr(), part)),
            N1, N2, H, W, int(radius), splits, ctypes.c_void_p(stream))
    _raise_on(lib, err, radius)
    LAUNCHES["zncc_search"] += 1
    return (du[0], dv[0], sc[0]) if single else (du, dv, sc)
