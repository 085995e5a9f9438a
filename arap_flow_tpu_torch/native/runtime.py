"""Python surface of the native host library (native/runtime.py of the JAX
package, without its numpy fallbacks).

The library (``src/arap_native.cpp``) is built with g++ on first use by
``_build.load_native``; a failed build or load raises. It holds:

- ``rasterize_warp``: the reference-exact forward splat, bitwise equal to
  ``host_raster.rasterize_warp_exact`` (its plain version);
- ``flo_write`` / ``flo_read``: the .flo codec, byte-equal to ``io.flo``;
- ``AsyncWriter``: a pool of writer threads for .flo fields and encoded
  images; each submit copies its data;
- ``jpeg_info`` / ``jpeg_decode`` / ``jpeg_encode``: the JPEG codec behind
  ``io.image`` (baseline and progressive decode of 1, 3 or 4 components,
  baseline encode). A file it does not decode raises ValueError: a broken
  one plain ValueError, one of a variant it does not implement (arithmetic
  coding, 12-bit samples, lossless, ...) ``JpegUnsupported``, a subclass,
  which ``io.image`` hands to PIL.

Its LANCZOS resample (``resize_lanczos_window``) is called from
``io.resize``, which holds its Python surface.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


def _lib() -> ctypes.CDLL:
    return _build.load_native()


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def rasterize_warp(warp: np.ndarray, rgb: np.ndarray, arap_mask: np.ndarray):
    """Reference-exact forward rasterization (C++). warp: (H, W, 2) float32
    absolute positions; rgb: (H, W, 3) uint8; arap_mask: (H, W), 0 = drawn.
    Returns (warped rgb (H, W, 3) uint8, warped mask (H, W) uint8)."""
    H, W = arap_mask.shape
    if warp.shape != (H, W, 2) or rgb.shape != (H, W, 3):
        raise ValueError(f"rasterize_warp: warp {warp.shape}, rgb "
                         f"{rgb.shape}, mask {arap_mask.shape}")
    warp = np.ascontiguousarray(warp, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    mask = np.ascontiguousarray(arap_mask, np.uint8)
    out_rgb = np.zeros((H, W, 3), np.uint8)
    out_mask = np.zeros((H, W), np.uint8)
    _lib().raster_warp(_ptr(warp), _ptr(rgb), _ptr(mask), H, W,
                       _ptr(out_rgb), _ptr(out_mask))
    return out_rgb, out_mask


def flo_write(path, uv: np.ndarray) -> None:
    """(H, W, 2) float32 -> .flo (C++)."""
    uv = np.ascontiguousarray(uv, np.float32)
    H, W = uv.shape[:2]
    rc = _lib().flo_write_file(str(path).encode(), _ptr(uv), W, H)
    if rc != 0:
        raise OSError(f"flo_write_file({path}) failed rc={rc}")


def flo_read(path) -> tuple[np.ndarray, np.ndarray]:
    """.flo -> (u, v) float32 (H, W) arrays (C++)."""
    lib = _lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.flo_read_file(str(path).encode(), None, 0, ctypes.byref(w),
                           ctypes.byref(h))
    if rc != 0:
        raise OSError(f"flo_read_file({path}) header failed rc={rc}")
    buf = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.flo_read_file(str(path).encode(), _ptr(buf), buf.size,
                           ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise OSError(f"flo_read_file({path}) failed rc={rc}")
    return buf[:, :, 0].copy(), buf[:, :, 1].copy()


class AsyncWriter:
    """Threaded native file writer: .flo fields and encoded bytes are
    written off the caller's thread. Each submit copies its data. The pool
    is process-wide in the library, so one writer is open at a time: a
    second one raises (its close would stop the first one's threads)."""

    _open = False

    def __init__(self, threads: int = 4):
        if AsyncWriter._open:
            raise RuntimeError("an AsyncWriter is already open in this "
                               "process")
        self.lib = _lib()
        self.lib.writer_start(max(1, int(threads)))
        self.started = AsyncWriter._open = True

    def submit_flo(self, path, uv: np.ndarray) -> None:
        uv = np.ascontiguousarray(uv, np.float32)
        H, W = uv.shape[:2]
        self.lib.writer_submit_flo(str(path).encode(), _ptr(uv), W, H)

    def submit_bytes(self, path, data: bytes) -> None:
        self.lib.writer_submit_bytes(str(path).encode(), data, len(data))

    def drain(self) -> None:
        if self.started:
            self.lib.writer_drain()

    def errors(self) -> int:
        """Failed-write count of this writer's lifetime; it stays readable
        after close() (callers check it after draining to decide whether the
        product tree can be trusted)."""
        return int(self.lib.writer_errors())

    def close(self) -> None:
        if self.started:
            self.lib.writer_drain()
            self.lib.writer_stop()
            self.started = AsyncWriter._open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JpegUnsupported(ValueError):
    """A JPEG of a variant the native decoder does not implement; libjpeg
    (PIL) may read it."""


def _jpeg_error(lib, rc: int = -1) -> ValueError:
    msg = lib.jpeg_last_error().decode(errors="replace")
    return JpegUnsupported(msg) if rc == -2 else ValueError(msg)


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(height, width, components) from a JPEG's frame header."""
    lib = _lib()
    H, W, C = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(data, len(data), ctypes.byref(H), ctypes.byref(W),
                     ctypes.byref(C)) != 0:
        raise _jpeg_error(lib)
    return H.value, W.value, C.value


def jpeg_decode(data: bytes) -> np.ndarray:
    """Decode a baseline or progressive JPEG: (H, W) uint8 for one
    component, (H, W, 3) RGB for three, (H, W, 4) CMYK for four, inverted
    as PIL's "CMYK;I" raw mode gives it; each equal to
    ``np.array(Image.open(f))`` (libjpeg-turbo's default decode)."""
    lib = _lib()
    H, W, C = jpeg_info(data)
    out = np.empty((H, W) if C == 1 else (H, W, C), np.uint8)
    rc = lib.jpeg_decode(data, len(data), _ptr(out), H, W, C)
    if rc != 0:
        raise _jpeg_error(lib, rc)
    return out


def jpeg_encode(arr: np.ndarray, quality: int = 75) -> bytes:
    """Encode an (H, W) gray or (H, W, 3) RGB uint8 array as a baseline
    JFIF file (4:2:0 chroma) at `quality` (1-100)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"jpeg_encode: shape {arr.shape} is not (H, W[, 3])")
    lib = _lib()
    C = 1 if arr.ndim == 2 else 3
    n = lib.jpeg_encode(_ptr(arr), arr.shape[0], arr.shape[1], C,
                        int(quality))
    if n < 0:
        raise _jpeg_error(lib)
    out = np.empty(n, np.uint8)
    lib.jpeg_take(_ptr(out))
    return out.tobytes()
