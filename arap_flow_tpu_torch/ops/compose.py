"""Per-segment output composition and background compositing
(ops/compose.py of the JAX package): the reference's flatten() and add_bg()
(para_gen.py:136-175, 50-61) as torch functions on the tensors' device.
"""

from __future__ import annotations

import torch


def compose_segments(flows: torch.Tensor, rgbs: torch.Tensor,
                     masks: torch.Tensor):
    """Compose per-segment products into one frame: flows (S, 2, H, W),
    rgbs (S, 3, H, W), masks (S, H, W). Segment i overwrites wherever
    masks[i] != 0, in segment order (the last write wins). Returns (flow
    (2, H, W), rgb (3, H, W), mask (H, W))."""
    flow, rgb, mask = flows[0], rgbs[0], masks[0]
    for f, r, m in zip(flows[1:], rgbs[1:], masks[1:]):
        ob = m != 0
        flow = torch.where(ob[None], f, flow)
        rgb = torch.where(ob[None], r, rgb)
        mask = torch.where(ob, m, mask)
    return flow, rgb, mask


def add_background(rgb: torch.Tensor, mask: torch.Tensor, bg: torch.Tensor,
                   bgval: float = 0.0) -> torch.Tensor:
    """rgb, except the background image where mask == bgval: rgb and bg
    (3, H, W) or (H, W, 3), mask (H, W)."""
    sel = mask == bgval
    sel = sel[None] if rgb.ndim == 3 and rgb.shape[0] == 3 else sel[..., None]
    return torch.where(sel, bg, rgb)
