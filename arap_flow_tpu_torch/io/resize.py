"""PIL-exact image resizes (Pillow's Resample.c and Geometry.c), so
``--size`` and ``--bg_dir`` need no PIL.

- ``resize_lanczos_window`` (uint8, (H, W) or (H, W, C), C = 1-4): rows
  [top, top + height) and columns [left, left + width) of Pillow's
  ``ImagingResample`` with the LANCZOS filter to the full size (w, h),
  computed by the native host library (``resize_lanczos_window`` in
  ``native/src/arap_native.cpp``) without the rest of the output. Support
  3 scaled by the downscale factor; each output's coefficients come from
  its absolute index in the full output (center = (xx + 0.5)·scale),
  normalised in double, then converted to fixed point with PRECISION_BITS
  = 22 and round-half-away-from-zero; a horizontal pass over the input
  rows the window reads, then a vertical pass, each accumulated in int32
  and clipped to uint8. The window is bitwise the crop of the full resize.
  Pillow's own ``resize(..., box=)`` is not: it resamples the box as a
  smaller input, whose coefficients differ by 1-2 levels. The routine is
  single-threaded and runs without the GIL (ctypes), so a resize on one
  thread overlaps another thread's.
- ``resize_lanczos``: the whole output, the window that covers it.
- ``resize_nearest``: Pillow's NEAREST resize (``ImagingScaleAffine``): the
  source index of output x is trunc of 0.5·s + x·s, with s = in/out summed
  one step at a time as Pillow does.

``resize_lanczos`` and ``resize_nearest`` are bitwise equal to
``PIL.Image.resize`` (tests/test_torch_jpeg.py). ``RESAMPLED`` counts the
LANCZOS output pixels computed (``"computed"``) and those of the full
resizes they were cut from (``"full"``): their ratio is the share of the
full work done.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from .. import _build

RESAMPLED: collections.Counter = collections.Counter()
_RESAMPLED_LOCK = threading.Lock()  # the main thread and the prep worker


def resize_lanczos_window(img: np.ndarray, size, top: int, left: int,
                          height: int, width: int) -> np.ndarray:
    """``resize_lanczos(img, size)[top:top + height, left:left + width]``,
    computing only that window; size is (width, height) of the full
    resize."""
    w, h = int(size[0]), int(size[1])
    top, left, height, width = int(top), int(left), int(height), int(width)
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {size}")
    if (height <= 0 or width <= 0 or top < 0 or left < 0
            or top + height > h or left + width > w):
        raise ValueError(f"window {height}x{width} at ({top}, {left}) of a "
                         f"resize to {size}")
    img = np.ascontiguousarray(img, np.uint8)
    flat = img.ndim == 2
    x = img[..., None] if flat else img
    H, W, C = x.shape
    if not 1 <= C <= 4:
        raise ValueError(f"resize of {C} channels (1-4)")
    out = np.empty((height, width, C), np.uint8)
    rc = _build.load_native().resize_lanczos_window(
        x.ctypes.data, H, W, C, w, h, top, left, height, width,
        out.ctypes.data)
    if rc == -2:
        raise MemoryError(f"resize of {img.shape} to {size}")
    if rc != 0:
        raise ValueError(f"resize of {img.shape} to {size}")
    with _RESAMPLED_LOCK:
        RESAMPLED["computed"] += height * width
        RESAMPLED["full"] += h * w
    return out[..., 0] if flat else out


def resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """PIL ``Image.resize(size, LANCZOS)`` of a uint8 (H, W) or (H, W, C)
    array, C = 1-4; size is (width, height)."""
    return resize_lanczos_window(img, size, 0, 0, size[1], size[0])


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
