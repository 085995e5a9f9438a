"""Coarse-to-fine (two-level warm start) ARAP solving, an opt-in mode
(ops/pyramid.py of the JAX package).

The annealed schedule runs on the half-resolution problem; its flow (×2,
bilinear, values doubled) and angle (bilinear) start the full-resolution
solve, which then runs ``fine_anneal`` annealed steps of the same GN and
PCG counts. Both levels take the solver's route for their device, so on a
card each GN step is one ``pcg_fixed`` launch.

The JAX package measured this mode on its golden fixture at 0.62 px mean
EPE (fine_anneal = 1) against the flat schedule's 0.064 px: it changes the
optimisation trajectory, so it is for callers that accept that accuracy,
not for the reference-parity path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import energy as E
from . import solver as S


def coarsen_problem(arap_mask: np.ndarray, constraints: np.ndarray,
                    weights: E.ArapWeights = E.ArapWeights(), *, device):
    """Half-resolution operands (H // 2, W // 2): a coarse pixel is in the
    solve region when any of its 2×2 fine pixels is, and the constraint
    coordinates are halved, later duplicates winning as in build_operands.
    Returns (operands, (H2, W2))."""
    arap_mask = np.asarray(arap_mask)
    H, W = arap_mask.shape
    H2, W2 = H // 2, W // 2
    m = (arap_mask == 0)[: H2 * 2, : W2 * 2]
    m2 = m.reshape(H2, 2, W2, 2).any((1, 3))
    coarse_mask = np.where(m2, 0, 255).astype(np.uint8)
    cons = np.asarray(constraints, np.int64).reshape(-1, 4) // 2
    cons = cons[(cons[:, 0] < W2) & (cons[:, 1] < H2)]
    return E.build_operands(coarse_mask, cons.astype(np.int32), weights,
                            device=device), (H2, W2)


def _upsample(a: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear resize of (C, h, w) planes to (C, H, W) with half-pixel
    centres: ``jax.image.resize(..., "bilinear")`` for an upsample."""
    return F.interpolate(a[None], size=(H, W), mode="bilinear",
                         align_corners=False)[0]


def solve_pyramid(arap_mask: np.ndarray, constraints: np.ndarray,
                  cfg: S.SolverConfig,
                  weights: E.ArapWeights = E.ArapWeights(),
                  fine_anneal: int = 1, *, device):
    """Two-level coarse-to-fine solve; returns (x (3, H, W), flow (2, H, W))
    on the fine grid, on `device`. `cfg` applies to the coarse level; the
    fine level runs `fine_anneal` annealed steps of cfg's GN and PCG counts
    (its late budget). The fused backend runs the coarse level; the fine
    level, which starts from the upsampled state, goes GN step by GN step
    on the route ``auto`` picks."""
    arap_mask = np.asarray(arap_mask)
    H, W = arap_mask.shape
    ops_f = E.build_operands(arap_mask, constraints, weights, device=device)
    ops_c, _ = coarsen_problem(arap_mask, constraints, weights, device=device)
    x_c, flow_c = S.solve(ops_c, cfg)

    flow_f = _upsample(flow_c, H, W) * 2.0
    angle_f = _upsample(x_c[2:3], H, W)
    rest = E.init_state(ops_f)
    # excluded pixels start at rest, as in the flat solve
    x = torch.where(ops_f.mask[None] > 0,
                    torch.cat([ops_f.grid + flow_f, angle_f]), rest)

    fine = cfg._replace(num_anneal=fine_anneal)
    if fine.backend == "fused":
        fine = fine._replace(backend="auto")
    fine = S.resolve_for(ops_f, fine)
    for i in range(fine.num_anneal):
        alpha = np.float32(i + 1.0) / np.float32(fine.num_anneal)
        cimg = E.anneal_constraints(ops_f, alpha)
        for _ in range(fine.gn_iters):
            x, _ = S.gn_step(x, ops_f, cimg, fine, fine.pcg_iters,
                             fine.q_tolerance, fine.rz_tolerance)
    return x, S.flow_from_state(x, ops_f)
