"""Sintel benchmark auxiliary formats: depth, disparity, camera and
segmentation (io/sintel.py of the JAX package; the reference's
sintel_io.py:76-212). numpy only: the PNG-coded disparity and segmentation
go through the port's PNG codec (``io.image``), so their pixels equal the
JAX package's files while the compressed bytes differ.
"""

from __future__ import annotations

import numpy as np

from .flo import FLO_TAG_BYTES, FLO_TAG_FLOAT
from .image import load_rgb, png_encode


def depth_read(filename) -> np.ndarray:
    """Read depth (.dpt) as (H, W) float32."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != np.float32(FLO_TAG_FLOAT):
            raise ValueError(f"depth_read: wrong tag (is {check})")
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        size = width * height
        if not (width > 0 and height > 0 and 1 < size < 100000000):
            raise ValueError(f"depth_read: wrong input size ({width}x{height})")
        return np.fromfile(f, dtype=np.float32, count=-1).reshape(height, width)


def depth_write(filename, depth: np.ndarray) -> None:
    """Write depth (.dpt): the .flo tag, int32 width and height, float32
    rows."""
    height, width = depth.shape[:2]
    with open(filename, "wb") as f:
        f.write(FLO_TAG_BYTES)
        np.int32(width).tofile(f)
        np.int32(height).tofile(f)
        depth.astype(np.float32).tofile(f)


def _write_png(filename, rgb: np.ndarray) -> None:
    with open(filename, "wb") as f:
        f.write(png_encode(rgb))


def disparity_write(filename, disparity: np.ndarray, bitdepth: int = 16) -> None:
    """Write disparity PNG-coded in the RGB channels (clipped to [0, 1024]:
    R = d/4, G = d·64 mod 256, and B = d·2^14 mod 256 above 16 bits)."""
    d = disparity.copy()
    d[d > 1024] = 1024
    d[d < 0] = 0
    d_r = (d / 4.0).astype("uint8")
    d_g = ((d * (2.0 ** 6)) % 256).astype("uint8")
    out = np.zeros((d.shape[0], d.shape[1], 3), dtype="uint8")
    out[:, :, 0] = d_r
    out[:, :, 1] = d_g
    if bitdepth > 16:
        out[:, :, 2] = (d * (2 ** 14) % 256).astype("uint8")
    _write_png(filename, out)


def disparity_read(filename) -> np.ndarray:
    """Read PNG-coded disparity as (H, W) float64."""
    f_in = load_rgb(filename)
    d_r = f_in[:, :, 0].astype("float64")
    d_g = f_in[:, :, 1].astype("float64")
    d_b = f_in[:, :, 2].astype("float64")
    return d_r * 4 + d_g / (2 ** 6) + d_b / (2 ** 14)


def cam_read(filename) -> tuple[np.ndarray, np.ndarray]:
    """Read camera data -> (M intrinsic 3x3, N extrinsic 3x4), float64."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != np.float32(FLO_TAG_FLOAT):
            raise ValueError(f"cam_read: wrong tag (is {check})")
        M = np.fromfile(f, dtype="float64", count=9).reshape((3, 3))
        N = np.fromfile(f, dtype="float64", count=12).reshape((3, 4))
    return M, N


def cam_write(filename, M: np.ndarray, N: np.ndarray) -> None:
    """Write the camera's intrinsic and extrinsic matrices."""
    with open(filename, "wb") as f:
        f.write(FLO_TAG_BYTES)
        M.astype("float64").tofile(f)
        N.astype("float64").tofile(f)


def segmentation_write(filename, segmentation: np.ndarray) -> None:
    """Write an int segmentation RGB-coded (R, G, B = base-256 digits)."""
    seg = segmentation.astype("int32")
    out = np.zeros((seg.shape[0], seg.shape[1], 3), dtype="uint8")
    out[:, :, 0] = np.floor(seg / (256 ** 2)).astype("uint8")
    out[:, :, 1] = np.floor((seg % (256 ** 2)) / 256).astype("uint8")
    out[:, :, 2] = np.floor(seg % 256).astype("uint8")
    _write_png(filename, out)


def segmentation_read(filename) -> np.ndarray:
    """Read an RGB-coded segmentation as (H, W) int32."""
    f_in = load_rgb(filename)
    seg_r = f_in[:, :, 0].astype("int32")
    seg_g = f_in[:, :, 1].astype("int32")
    seg_b = f_in[:, :, 2].astype("int32")
    return (seg_r * 256 + seg_g) * 256 + seg_b
