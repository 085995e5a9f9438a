"""Matcher output, solver constraint files, the constraint filter and
border pins (numpy; copies of the JAX package's io/constraints.py, held
equal to them by the tests).

Matcher output has one match a line, ``x1 y1 x2 y2 [score ...]``. A solver
constraint file holds the count N, then N whitespace-separated 4-tuples
x1 y1 x2 y2.
"""

from __future__ import annotations

from math import sqrt

import numpy as np

MAX_CONSTRAINT_DIST = 60.0  # the reference's para_gen.py:223


def read_matches(path) -> np.ndarray:
    """Read matcher output lines; returns (N, 4) int32 x1 y1 x2 y2."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                rows.append([int(float(p)) for p in parts[:4]])
    return np.array(rows, dtype=np.int32).reshape(-1, 4)


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


def write_constraint_file(path, constraints: np.ndarray) -> None:
    """Write the count header and tab-separated 4-tuples."""
    lines = [str(len(constraints))]
    for x1, y1, x2, y2 in np.asarray(constraints, dtype=np.int64):
        lines.append(f"{x1:d}\t{y1:d}\t{x2:d}\t{y2:d}")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def valid_constraint(x1, y1, x2, y2, msk1: np.ndarray, msk2: np.ndarray) -> bool:
    """One match's validity (the reference's valid_cnstr, para_gen.py:216-223):
    inside both masks, 0 < distance < 60 px, starting on an object pixel and
    landing on the same segment id. Negative coordinates are rejected (the
    reference checks only the upper bounds), as in filter_matches."""
    if (
        x1 < 0 or y1 < 0 or x2 < 0 or y2 < 0
        or x1 >= msk1.shape[1]
        or x2 >= msk2.shape[1]
        or y1 >= msk1.shape[0]
        or y2 >= msk2.shape[0]
    ):
        return False
    dist = sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2)
    return (
        dist < MAX_CONSTRAINT_DIST
        and dist > 0
        and msk1[y1, x1] > 0
        and msk1[y1, x1] == msk2[y2, x2]
    )


def filter_matches(
    matches: np.ndarray, msk1: np.ndarray, msk2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised valid_constraint over (N, 4) matches; returns (kept (M, 4)
    int32, their segment ids (M,))."""
    m = np.asarray(matches, dtype=np.int64).reshape(-1, 4)
    if len(m) == 0:
        return m.astype(np.int32), np.zeros((0,), dtype=np.int64)
    x1, y1, x2, y2 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    inb = (
        (x1 >= 0) & (y1 >= 0) & (x2 >= 0) & (y2 >= 0)
        & (x1 < msk1.shape[1]) & (x2 < msk2.shape[1])
        & (y1 < msk1.shape[0]) & (y2 < msk2.shape[0])
    )
    xi1, yi1 = np.where(inb, x1, 0), np.where(inb, y1, 0)
    xi2, yi2 = np.where(inb, x2, 0), np.where(inb, y2, 0)
    dist2 = (x2 - x1) ** 2 + (y2 - y1) ** 2
    s1 = msk1[yi1, xi1].astype(np.int64)
    s2 = msk2[yi2, xi2].astype(np.int64)
    keep = (inb & (dist2 > 0) & (dist2 < MAX_CONSTRAINT_DIST ** 2) & (s1 > 0)
            & (s1 == s2))
    return m[keep].astype(np.int32), s1[keep]


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
