"""Middlebury .flo flow-field IO (numpy; byte-identical to the JAX
package's io/flo.py).

Layout: the 4-byte tag 'PIEH' (float32 202021.25, little-endian), int32
width, int32 height, then height rows of width interleaved (u, v) float32.
"""

from __future__ import annotations

import numpy as np

FLO_TAG_FLOAT = 202021.25
FLO_TAG_BYTES = b"PIEH"

_MAX_DIM = 99999


def flow_read(filename) -> tuple[np.ndarray, np.ndarray]:
    """Read a .flo file; returns (u, v) float32 arrays of shape (H, W)."""
    with open(filename, "rb") as f:
        data = f.read()
    return flow_decode(data)


def flow_decode(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Decode .flo bytes; returns (u, v) float32 arrays of shape (H, W)."""
    tag = np.frombuffer(data, dtype=np.float32, count=1)[0]
    if tag != np.float32(FLO_TAG_FLOAT):
        raise ValueError(
            f"flow_read: wrong tag in flow file (should be {FLO_TAG_FLOAT}, "
            f"is {tag}). Big-endian machine?"
        )
    width = int(np.frombuffer(data, dtype=np.int32, count=1, offset=4)[0])
    height = int(np.frombuffer(data, dtype=np.int32, count=1, offset=8)[0])
    size = width * height
    if not (0 < width <= _MAX_DIM and 0 < height <= _MAX_DIM
            and 1 < size < 100000000):
        raise ValueError(
            f"flow_read: wrong input size (width={width}, height={height})")
    tmp = np.frombuffer(data, dtype=np.float32, offset=12, count=size * 2)
    tmp = tmp.reshape(height, width * 2)
    return np.ascontiguousarray(tmp[:, 0::2]), np.ascontiguousarray(tmp[:, 1::2])


def flow_encode(uv: np.ndarray, v: np.ndarray | None = None) -> bytes:
    """Encode a flow field as .flo bytes: ``uv`` is (H, W, 2), or the u
    channel with ``v`` given separately."""
    if v is None:
        uv = np.asarray(uv)
        if uv.ndim != 3 or uv.shape[2] != 2:
            raise ValueError(f"flow_write: expected (H, W, 2), got {uv.shape}")
        u, v = uv[:, :, 0], uv[:, :, 1]
    else:
        u, v = np.asarray(uv), np.asarray(v)
    if u.shape != v.shape:
        raise ValueError(f"flow_write: u/v shape mismatch {u.shape} vs {v.shape}")
    height, width = u.shape
    tmp = np.empty((height, width * 2), dtype=np.float32)
    tmp[:, 0::2] = u
    tmp[:, 1::2] = v
    header = FLO_TAG_BYTES + np.int32(width).tobytes() + np.int32(height).tobytes()
    return header + tmp.tobytes()


def flow_write(filename, uv: np.ndarray, v: np.ndarray | None = None) -> None:
    """Write a flow field to a .flo file."""
    with open(filename, "wb") as f:
        f.write(flow_encode(uv, v))
