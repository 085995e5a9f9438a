"""Energies over an explicit edge list (ops/graph.py of the JAX package, the
OptGraph analogue).

Residuals over (E, 2) vertex-index pairs into flattened pixel or vertex
arrays, evaluated with gathers and differentiated by ``ops.generic``, so
problems of irregular connectivity run on the same GN/PCG machinery.
``arap_graph_residuals`` over ``grid_edges`` is the stencil's
regularisation term, which the tests check against ops/energy.py.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_edges(arap_mask: np.ndarray) -> np.ndarray:
    """The 4-neighbour edges of the solve region (arap_mask == 0), directed
    both ways, in ``DIRS`` order: the stencil's residual set as an (E, 2)
    int32 array of flat indices."""
    H, W = arap_mask.shape
    m = arap_mask == 0
    idx = np.arange(H * W).reshape(H, W)
    edges = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        ys, xs = np.where(m)
        yj, xj = ys + dy, xs + dx
        ok = (yj >= 0) & (yj < H) & (xj >= 0) & (xj < W)
        ok_idx = np.where(ok)[0]
        keep = ok_idx[m[yj[ok_idx], xj[ok_idx]]]
        edges.append(
            np.stack([idx[ys[keep], xs[keep]], idx[yj[keep], xj[keep]]], 1))
    return np.concatenate(edges, 0).astype(np.int32)


def arap_graph_residuals(x: torch.Tensor, edges: torch.Tensor,
                         urshape: torch.Tensor, w_reg_sqrt) -> torch.Tensor:
    """Per-edge ARAP regularisation residuals, (E, 2):
    w·((o_i − o_j) − R(a_i)(u_i − u_j)) for x (3, N) = [ox, oy, angle] over
    flattened vertices and urshape (2, N)."""
    i = edges[:, 0].long()
    j = edges[:, 1].long()
    a = x[2, i]
    s, c = torch.sin(a), torch.cos(a)
    dux = urshape[0, i] - urshape[0, j]
    duy = urshape[1, i] - urshape[1, j]
    rx = (x[0, i] - x[0, j]) - (c * dux - s * duy)
    ry = (x[1, i] - x[1, j]) - (s * dux + c * duy)
    return w_reg_sqrt * torch.stack([rx, ry], 1)


def fit_graph_residuals(x: torch.Tensor, verts: torch.Tensor,
                        targets: torch.Tensor, w_fit_sqrt) -> torch.Tensor:
    """Point-constraint residuals over a vertex list, (K, 2):
    w·(o_v − target_v) for targets (K, 2)."""
    v = verts.long()
    rx = x[0, v] - targets[:, 0]
    ry = x[1, v] - targets[:, 1]
    return w_fit_sqrt * torch.stack([rx, ry], 1)
