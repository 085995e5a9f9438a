"""PNG/mask IO (numpy; copies of the JAX package's io/image.py).

PIL is imported inside each function, so the package imports without it
(the solve path needs no image codec).

Mask conventions: annotation masks use 0 = background, nonzero = segment
id; ARAP solver masks use 0 = solve region, 255 = excluded.
"""

from __future__ import annotations

import numpy as np


def load_rgb(path) -> np.ndarray:
    """Load an RGB image as (H, W, 3) uint8 (alpha dropped, gray replicated)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im if im.mode == "RGB" else im.convert("RGB"))


def load_mask(path) -> np.ndarray:
    """Load a mask as (H, W): palette/gray ids kept, channel 0 of RGB."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.array(im)
    return arr[:, :, 0] if arr.ndim == 3 else arr


def image_size(path) -> tuple[int, int]:
    """(H, W) of an image from its header, without decoding the pixels."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


def save_image(path, arr: np.ndarray) -> None:
    """Save an (H, W[, 3]) uint8 array; PNGs at compress_level=1."""
    from PIL import Image

    im = Image.fromarray(np.asarray(arr, dtype=np.uint8))
    if str(path).lower().endswith(".png"):
        im.save(path, compress_level=1)
    else:
        im.save(path)
