"""Solver constraint files and border pins (numpy; copies of the JAX
package's io/constraints.py helpers, held equal to them by the tests).

A solver constraint file holds the count N, then N whitespace-separated
4-tuples x1 y1 x2 y2.
"""

from __future__ import annotations

import numpy as np


def read_constraint_file(path) -> np.ndarray:
    """Read a solver constraint file (N header + 4-tuples) -> (N, 4) int32."""
    with open(path) as f:
        tokens = f.read().split()
    if not tokens:
        return np.zeros((0, 4), dtype=np.int32)
    n = int(tokens[0])
    vals = [int(t) for t in tokens[1 : 1 + 4 * n]]
    if len(vals) != 4 * n:
        raise ValueError(f"constraint file {path}: expected {n} 4-tuples")
    return np.array(vals, dtype=np.int32).reshape(n, 4)


def add_border_pins(constraints: np.ndarray, width: int, height: int) -> np.ndarray:
    """Append identity constraints pinning every border pixel, in row-major
    order (y outer, x inner)."""
    xr = np.arange(width, dtype=np.int32)
    ymid = np.arange(1, height - 1, dtype=np.int32)
    rows = [np.stack([xr, np.zeros(width, np.int32)], 1)]
    if height > 1:
        edges = np.empty((ymid.size * 2, 2), np.int32)
        edges[0::2, 0] = 0
        edges[1::2, 0] = width - 1
        edges[0::2, 1] = ymid
        edges[1::2, 1] = ymid
        rows.append(edges if width > 1 else edges[0::2])
        rows.append(np.stack([xr, np.full(width, height - 1, np.int32)], 1))
    b = np.concatenate(rows, axis=0)
    pins = np.concatenate([b, b], axis=1)
    constraints = np.asarray(constraints, dtype=np.int32).reshape(-1, 4)
    return np.concatenate([constraints, pins], axis=0)
