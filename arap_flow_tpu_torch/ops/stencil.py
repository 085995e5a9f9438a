"""Zero-padded stencil shifts over (..., H, W) tensors (ops/stencil.py of the
JAX package).

The ARAP energy couples each pixel to its 4-neighbourhood; a shifted copy
with zeros outside the image implements the plan's InBounds gating when it
is combined with the multiplicative direction masks.
"""

from __future__ import annotations

import torch

# Stencil directions as (dy, dx), in the JAX package's order.
DIRS: tuple[tuple[int, int], ...] = ((0, 1), (0, -1), (1, 0), (-1, 0))


def shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Return b with b[..., y, x] = a[..., y+dy, x+dx], zero out of bounds."""
    H, W = a.shape[-2], a.shape[-1]
    out = torch.zeros_like(a)
    ys = slice(max(dy, 0), H + min(dy, 0))
    yd = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    xd = slice(max(-dx, 0), W + min(-dx, 0))
    out[..., yd, xd] = a[..., ys, xs]
    return out
