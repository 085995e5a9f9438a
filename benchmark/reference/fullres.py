"""The plain reference of ``para_gen --size W H --bg_dir DIR --seed S`` over
full-resolution frames, written from the reference's ``para_gen.py``
(``scale_rotate`` :253-291, ``fit_bg``/``add_bg`` :36-61, the pair's
order of work :440-560) in plain torch, int64 where Pillow computes in
integers and float64 where it computes in doubles. Imports nothing of the
program, no PIL and no JAX.

- ``resize_lanczos``: Pillow's ``ImagingResample`` with the LANCZOS
  filter. Support 3 scaled by the downscale factor; each output's taps
  from ``int(center ± support + 0.5)``, the filter values normalised by
  their sum taken tap by tap, converted to fixed point with 22 bits and
  rounded half away from zero; a horizontal pass, then a vertical pass,
  each accumulated from 2^21 and clipped to uint8 after a shift by 22.
- ``resize_nearest``: Pillow's NEAREST resize, an affine scale whose
  source position starts at half a step and grows by one step (in = in /
  out) an output at a time; its integer part is the source index.
- ``scale_rotate``: portrait frames transposed; the frame resized so that
  both sides reach the target plus 10 px, then centre-cropped.
- ``background_draws`` and ``fit_background``: the pool's draws replayed
  from ``np.random.default_rng(seed)``: for each pair, in the order the
  pairs are prepared, a background drawn without replacement from the
  sorted pool (refilled when it runs empty), then ``uniform(1, 2)`` for
  the upscale, then ``integers`` for the crop's row, then for its column.
- ``add_bg``: the background where the mask is 0.
- ``pairs_with_backgrounds``: a pair's products. The matcher and the
  constraint filter see the resized frames without a background; each
  segment's solve uses the masks. ``compose``: the rasterizer warps frame
  1 with the background composited under it; segments are composed in id
  order, a later one drawn over an earlier one (``flatten``); the
  background is composited again where the composed warped mask is 0.

Departures from the reference's ``para_gen.py``:

- The replay of the draws holds only where every pair of a job reaches
  its draw: a pair that fails before it (empty masks, no match kept)
  takes no draw, and every later pair's background then differs. The
  benchmark holds every pair to its products (``pairs_missing`` = 0), so
  a job in which a pair skips its draw already fails.
- Matches come from the plain ZNCC matcher (``matcher.py``) in place of
  DeepMatching, and the solve is ``pipeline.py``'s batched plain PCG, as
  in the ``davis480`` reference.
- ``dtype`` below float64 (the control) computes the LANCZOS filter
  values and their normalisation in that precision, and the solve in it;
  the tap bounds and the NEAREST positions are index arithmetic and stay
  in float64, the matcher in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pipeline
from .matcher import match_pair

PRECISION_BITS = 22  # Pillow's fixed point for 8-bit images (32 - 8 - 2)
SUPPORT = 3.0  # the LANCZOS filter's support (a = 3)
SLACK = 10  # px added to each target side before the crop


def _lanczos(x: torch.Tensor) -> torch.Tensor:
    """sinc(x)·sinc(x/3) on [-3, 3), 0 elsewhere."""
    def sinc(v):
        pv = v * math.pi
        safe = torch.where(v == 0, torch.ones_like(v), pv)
        return torch.where(v == 0, torch.ones_like(v), torch.sin(safe) / safe)

    inside = (x >= -SUPPORT) & (x < SUPPORT)
    return torch.where(inside, sinc(x) * sinc(x / 3), torch.zeros_like(x))


def lanczos_taps(in_size: int, out_size: int, dtype=torch.float64):
    """(first tap (out,) int64, fixed-point weights (out, K) int64) of a
    LANCZOS resize of one axis; weights past an output's own count are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    K = int(math.ceil(support)) * 2 + 1
    center = (torch.arange(out_size, dtype=torch.float64) + 0.5) * scale
    xmin = torch.trunc(center - support + 0.5).clamp(min=0)
    count = torch.trunc(center + support + 0.5).clamp(max=in_size) - xmin
    x = torch.arange(K, dtype=torch.float64)[None, :]
    pos = (x + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)
    live = x < count[:, None]
    w = torch.where(live, _lanczos(pos.to(dtype)),
                    torch.zeros((), dtype=dtype))
    total = torch.zeros(out_size, dtype=dtype)
    for j in range(K):  # summed tap by tap, in Pillow's order
        total = total + w[:, j]
    w = torch.where(total[:, None] != 0, w / total[:, None], w)
    scaled = w.to(torch.float64) * (1 << PRECISION_BITS)
    fixed = torch.where(scaled < 0, torch.trunc(scaled - 0.5),
                        torch.trunc(scaled + 0.5))
    return xmin.to(torch.int64), fixed.to(torch.int64)


def _resample(img: torch.Tensor, out_size: int, axis: int,
              dtype) -> torch.Tensor:
    """One fixed-point pass along `axis` (0 rows, 1 columns) of an (H, W,
    C) int64 image; returns int64 values in 0..255."""
    in_size = img.shape[axis]
    first, k = lanczos_taps(in_size, out_size, dtype)
    first, k = first.to(img.device), k.to(img.device)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int64,
                     device=img.device)
    for j in range(k.shape[1]):
        src = (first + j).clamp(max=in_size - 1)  # past the count k is 0
        acc = acc + img.index_select(axis, src) * k[:, j].view(shape)
    return (acc >> PRECISION_BITS).clamp(0, 255)


def resize_lanczos(img: np.ndarray, size, device="cpu",
                   dtype=torch.float64) -> np.ndarray:
    """Pillow's ``resize(size, LANCZOS)`` of a uint8 (H, W, C) array; size
    is (width, height)."""
    w, h = int(size[0]), int(size[1])
    x = torch.as_tensor(np.asarray(img, np.uint8)).to(device, torch.int64)
    if x.shape[1] != w:
        x = _resample(x, w, 1, dtype)
    if x.shape[0] != h:
        x = _resample(x, h, 0, dtype)
    return x.to(torch.uint8).cpu().numpy()


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output of Pillow's NEAREST scale."""
    step = in_size / out_size
    pos, idx = step * 0.5, []
    for _ in range(out_size):
        idx.append(min(int(pos), in_size - 1))
        pos += step
    return np.asarray(idx, np.int64)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """Pillow's ``resize(size, NEAREST)``; size is (width, height)."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    t = torch.as_tensor(img)
    t = t.index_select(0, torch.as_tensor(nearest_index(H, h)))
    return t.index_select(1, torch.as_tensor(nearest_index(W, w))).numpy()


def resized_size(H: int, W: int, size) -> tuple:
    """(w, h, left, upper): the frame's size after the resize and the
    crop box's corner, for a target `size` (w, h)."""
    r = max(float(size[0] + SLACK) / W, float(size[1] + SLACK) / H)
    w, h = int(W * r), int(H * r)
    return w, h, w // 2 - size[0] // 2, h // 2 - size[1] // 2


def scale_rotate(im: np.ndarray, mk: np.ndarray, size, device="cpu",
                 dtype=torch.float64):
    """(frame, mask) transposed if portrait, resized and centre-cropped to
    `size` (w, h); as they are where they already have that size."""
    if im.shape[0] > im.shape[1]:
        im, mk = im.swapaxes(0, 1), mk.swapaxes(0, 1)
    H, W = im.shape[:2]
    if (W, H) == tuple(size):
        return np.ascontiguousarray(im), np.ascontiguousarray(mk)
    w, h, left, upper = resized_size(H, W, size)
    box = (slice(upper, upper + size[1]), slice(left, left + size[0]))
    return (np.ascontiguousarray(
                resize_lanczos(im, (w, h), device, dtype)[box]),
            np.ascontiguousarray(resize_nearest(mk, (w, h))[box]))


def background_draws(n_pairs: int, bg_hws: list, frame_hw: tuple,
                     seed) -> list:
    """For each of `n_pairs` pairs in order: (background's index in the
    sorted pool, upscaled (w, h), crop row, crop column), replayed from
    ``np.random.default_rng(seed)``. `bg_hws` holds each background's (H,
    W) in pool order; the crop is `frame_hw` (H, W)."""
    rng = np.random.default_rng(seed)
    imh, imw = frame_hw
    pool, out = [], []
    for _ in range(n_pairs):
        if not pool:
            pool = list(range(len(bg_hws)))
        b = pool.pop(int(rng.integers(0, len(pool))))
        bgh, bgw = bg_hws[b]
        r = rng.uniform(1, 2) * max(float(max(bgh, imh)) / bgh,
                                    float(max(bgw, imw)) / bgw)
        w, h = int(bgw * r), int(bgh * r)
        sy = int(rng.integers(0, h - imh + 1))
        sx = int(rng.integers(0, w - imw + 1))
        out.append((b, (w, h), sy, sx))
    return out


def fit_background(bg: np.ndarray, draw: tuple, frame_hw: tuple,
                   device="cpu", dtype=torch.float64) -> np.ndarray:
    """The crop a draw (from ``background_draws``) takes of background
    `bg`: the whole background upscaled, then cut to `frame_hw`."""
    _, wh, sy, sx = draw
    up = resize_lanczos(bg, wh, device, dtype)
    return up[sy:sy + frame_hw[0], sx:sx + frame_hw[1], :3]


def add_bg(im: np.ndarray, mk: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """`im` with `bg` where `mk` is 0."""
    return np.where((mk == 0)[..., None], bg, im).astype(np.uint8)


def compose(inp: np.ndarray, bg: np.ndarray, segments: list,
            device) -> dict:
    """A pair's products from its solved segments [(id, ARAP mask, warp (2,
    H, W))] in id order: each rasterized from `inp` (frame 1 over its
    background) on the whole frame, a later one drawn over an earlier one,
    then `bg` where the composed warped mask is 0."""
    out = None
    for s, mk, warp in segments:
        flow, wrgb, wmask = pipeline._raster(warp, inp, mk, device)
        if out is None:
            out = {"flow": flow.copy(), "wrgb": wrgb.copy(),
                   "wmask": wmask.copy(), "inp": inp, "ids": []}
        else:
            ob = wmask != 0
            for key, v in (("flow", flow), ("wrgb", wrgb), ("wmask", wmask)):
                out[key][ob] = v[ob]
        out["ids"].append(s)
    out["wrgb"] = add_bg(out["wrgb"], out["wmask"], bg)
    return out


def pairs_with_backgrounds(pairs, device, schedule=(19, 8, 400),
                           dtype=torch.float32) -> list:
    """The products of pairs [(frame 1, mask 1, frame 2, mask 2, background
    crop)], all preprocessed: one dict a pair (``compose``), or None where
    the pair has no products. The matcher and the filter see the frames
    without their background; every segment of every pair is solved in
    one batch."""
    problems, owners = [], []
    for k, (im1, mk1, im2, mk2, _) in enumerate(pairs):
        if (mk1 != 0).sum() <= 10 or (mk2 != 0).sum() <= 10:
            continue
        kept, seg = pipeline.filter_matches(match_pair(im1, im2, mk1, device),
                                            mk1, mk2)
        H, W = mk1.shape
        pins = pipeline.border_pins(W, H)
        for s in np.unique(seg):
            if s:
                problems.append((np.where(mk1 == s, 0, 255).astype(np.uint8),
                                 np.concatenate([kept[seg == s], pins])))
                owners.append((k, int(s)))
    warps = (pipeline._solve_boxes(problems, *pairs[0][1].shape, device,
                                   schedule, dtype) if problems else [])
    segments = [[] for _ in pairs]
    for (k, s), (mk, _), warp in zip(owners, problems, warps):
        segments[k].append((s, mk, warp))
    return [compose(add_bg(im1, mk1, bg), bg, segs, device) if segs else None
            for (im1, mk1, _, _, bg), segs in zip(pairs, segments)]
