"""PIL-exact image resizes in numpy (Pillow's Resample.c and Geometry.c), so
``--size`` and ``--bg_dir`` need no PIL.

- ``resize_lanczos`` (uint8, (H, W) or (H, W, C)): Pillow's
  ``ImagingResample`` with the LANCZOS filter. Support 3 scaled by the
  downscale factor; each output sample's coefficients are computed and
  normalised in double, then converted to fixed point with
  PRECISION_BITS = 22 and round-half-away-from-zero; a horizontal pass,
  then a vertical pass, each clipped to uint8.
- ``resize_nearest``: Pillow's NEAREST resize (``ImagingScaleAffine``): the
  source index of output x is trunc of 0.5·s + x·s, with s = in/out summed
  one step at a time as Pillow does.

Both are bitwise equal to ``PIL.Image.resize`` (tests/test_torch_jpeg.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np

PRECISION_BITS = 22  # 32 - 8 - 2, Pillow's fixed point for 8-bit images
_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for a box of the
    whole input: (xmin (out,), fixed-point coefficients (out, ksize) int32),
    zero past each output's own count. Cached: a run resizes many frames of
    one size."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.empty(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = w
        xmins[xx] = xmin
    scaled = kk * (1 << PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmins, fixed.astype(np.int32)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point pass along `axis` (0 rows, 1 columns) of a (H, W, C)
    uint8 image."""
    in_size = img.shape[axis]
    xmins, k = _coefficients(in_size, out_size)
    # int32 sums, as Pillow's: |sum| < 255 · Σ|k| < 2^31
    acc = np.full((out_size, img.shape[1 - axis], img.shape[2]),
                  1 << (PRECISION_BITS - 1), np.int32)
    src = np.ascontiguousarray(img if axis == 0 else img.transpose(1, 0, 2))
    tmp = np.empty_like(acc)
    for j in range(k.shape[1]):
        idx = np.minimum(xmins + j, in_size - 1)  # past the count k is 0
        np.multiply(src[idx], k[:, j, None, None], out=tmp)
        acc += tmp
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return out if axis == 0 else out.transpose(1, 0, 2)


def resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """PIL ``Image.resize(size, LANCZOS)`` of a uint8 (H, W) or (H, W, C)
    array; size is (width, height)."""
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {size}")
    img = np.asarray(img, np.uint8)
    flat = img.ndim == 2
    x = img[..., None] if flat else img
    H, W = x.shape[:2]
    if W != w:
        x = _pass(x, w, axis=1)
    if H != h:
        x = _pass(x, h, axis=0)
    x = np.ascontiguousarray(x)
    return x[..., 0] if flat else x


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """PIL ``Image.resize(size, NEAREST)`` of an (H, W) or (H, W, C) array;
    size is (width, height)."""
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {size}")
    img = np.asarray(img)
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    return np.ascontiguousarray(
        img[_nearest_index(H, h)][:, _nearest_index(W, w)])
