""".imagedump raw float-image debug format (io/imagedump.py of the JAX
package; Opt's dump, im.t): int32 width, height, channel count and
datatype (0 = float32, others reserved), then row-major float32 pixels with
no padding.
"""

from __future__ import annotations

import numpy as np


def imagedump_write(path, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, C) float data as .imagedump."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    with open(path, "wb") as f:
        np.array([W, H, C, 0], np.int32).tofile(f)
        np.ascontiguousarray(img).tofile(f)


def imagedump_read(path) -> np.ndarray:
    """Read .imagedump -> (H, W, C) float32."""
    with open(path, "rb") as f:
        W, H, C, dtype = np.fromfile(f, np.int32, 4)
        if dtype != 0:
            raise ValueError(f"imagedump {path}: unsupported datatype {dtype}")
        data = np.fromfile(f, np.float32, W * H * C)
    return data.reshape(H, W, C)
