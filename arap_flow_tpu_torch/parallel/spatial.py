"""Row-split ARAP solve: image rows split over the mesh's 'space' axis, with
1-row halos (parallel/spatial.py of the JAX package).

The 4-neighbour stencil (arap_plan.t:14) needs one row of each neighbour per
JtJ or JtF apply, and the PCG dot products become sums over the shards.
Ghost rows are inert: every operand plane is padded with zero rows, whose
direction masks are zero, and each stencil output is cropped back to the
shard's own rows. So the solve equals the one-device solve up to the order
of the dot products' sums.

A shard is a contiguous band of H / space rows of every problem of a 'data'
slice, on its device. A halo row travels with ``.to(device,
non_blocking=True)``; a dot product's per-shard partials are summed on the
slice's first device in shard order and the total handed back to each
shard. The JAX package reaches no Pallas kernel here (it applies
``energy.apply_jtj`` in its own PCG loop), and neither does the port: this
is plain torch on every device.

Meant for frames larger than one device; the pipeline's default is the
data axis alone (``mesh.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import energy as E
from ..ops import solver as S
from ..ops.energy import ArapOperands
from .mesh import Mesh, batch_slices


def _pad_rows(a: torch.Tensor) -> torch.Tensor:
    return F.pad(a, (0, 0, 1, 1))


def _pad_ops(ops: ArapOperands) -> ArapOperands:
    """Zero ghost rows on every operand plane (the batch's weights, of one
    dimension, stay as they are)."""
    return ArapOperands(**{
        f.name: _pad_rows(v) if v.dim() >= 3 else v
        for f in dataclasses.fields(ops)
        for v in (getattr(ops, f.name),)
    })


def _crop(a: torch.Tensor) -> torch.Tensor:
    return a[..., 1:-1, :]


def _halo(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard with one ghost row above and below, copied from its
    neighbours' edge rows (zeros at the global border, matching the
    stencil's zero padding)."""
    out = []
    for k, a in enumerate(parts):
        zero = torch.zeros_like(a[..., :1, :])
        top = (parts[k - 1][..., -1:, :].to(a.device, non_blocking=True)
               if k > 0 else zero)
        bot = (parts[k + 1][..., :1, :].to(a.device, non_blocking=True)
               if k + 1 < len(parts) else zero)
        out.append(torch.cat([top, a, bot], dim=-2))
    return out


def _psum_dot(a: list[torch.Tensor], b: list[torch.Tensor]
              ) -> list[torch.Tensor]:
    """Per-problem Σ a·b over every shard: the partials summed on the first
    shard's device in shard order, the total handed back to each shard."""
    root = a[0].device
    total = None
    for x, y in zip(a, b):
        part = torch.sum(x * y, dim=(-3, -2, -1)).to(root, non_blocking=True)
        total = part if total is None else total + part
    return [total.to(x.device, non_blocking=True) for x in a]


def _pcg_spatial(ops_pad, s_h, c_h, jtf, diag, cfg: S.SolverConfig,
                 pcg_iters: float) -> list[torch.Tensor]:
    """Jacobi-PCG over the shards from δ = 0 (all lists hold one tensor a
    shard). State lives on the shards' own rows; only JtJ's input p gets
    halos (`s_h`, `c_h` are the linearisation's haloed planes). With a
    tolerance a problem whose ζ or rz test passes stops moving: its state
    is frozen on the device by its flag, with no read to the host, and the
    loop runs the budget."""
    n = len(jtf)
    b = [-j for j in jtf]
    pre = [S.guarded_invert(d) for d in diag]
    # fresh lists: the tolerance branch below writes their entries in place
    r = list(b)
    z = [pre[k] * r[k] for k in range(n)]
    p = list(z)
    rz = _psum_dot(r, z)
    rz0 = list(rz)
    delta = [torch.zeros_like(j) for j in jtf]
    budget = float(np.minimum(np.float32(cfg.max_pcg_iters),
                              np.float32(pcg_iters)))
    q_tol, rz_tol = float(cfg.q_tolerance), float(cfg.rz_tolerance)
    use_tols = q_tol > 0.0 or rz_tol > 0.0
    active = [torch.ones_like(v, dtype=torch.bool) for v in rz]
    q_prev = [torch.zeros_like(v) for v in rz]
    i = 0
    while i < budget:
        ph = _halo(p)
        ap = [_crop(E.apply_jtj(ph[k], ops_pad[k], s_h[k], c_h[k]))
              for k in range(n)]
        pap = _psum_dot(p, ap)
        alpha = [S._bc(torch.where(pap[k] > 0.0, rz[k] / pap[k], 0.0))
                 for k in range(n)]
        delta_n = [delta[k] + alpha[k] * p[k] for k in range(n)]
        r_n = [r[k] - alpha[k] * ap[k] for k in range(n)]
        z = [pre[k] * r_n[k] for k in range(n)]
        rz_new = _psum_dot(z, r_n)
        beta = [S._bc(torch.where(rz[k] > 0.0, rz_new[k] / rz[k], 0.0))
                for k in range(n)]
        p_n = [z[k] + beta[k] * p[k] for k in range(n)]
        if not use_tols:
            delta, r, p, rz = delta_n, r_n, p_n, rz_new
            i += 1
            continue
        q = [0.5 * v for v in _psum_dot(delta_n, [r_n[k] + b[k]
                                                  for k in range(n)])]
        it1 = float(np.float32(i + 1.0))
        for k in range(n):
            zeta = it1 * (q[k] - q_prev[k]) / torch.where(q[k] == 0.0, 1.0,
                                                           q[k])
            conv = ((q_tol > 0.0) & (zeta < q_tol)) | (
                (rz_tol > 0.0) & (rz_new[k] < rz_tol * rz_tol * rz0[k]))
            a3 = S._bc(active[k])
            delta[k] = torch.where(a3, delta_n[k], delta[k])
            r[k] = torch.where(a3, r_n[k], r[k])
            p[k] = torch.where(a3, p_n[k], p[k])
            rz[k] = torch.where(active[k], rz_new[k], rz[k])
            q_prev[k] = torch.where(active[k], q[k], q_prev[k])
            active[k] = active[k] & ~conv
        i += 1
    return delta


def _solve_one_spatial(ops: list[ArapOperands], cfg: S.SolverConfig):
    """The annealed GN solve of one 'data' slice whose rows are split over
    the shards `ops` (one operand set a shard, on its device). Honours the
    non-uniform schedule (pcg_iters_early / anneal_split) as
    ``solver.anneal_solve`` does. Returns the shards' states."""
    ops_pad = [_pad_ops(o) for o in ops]
    x = [E.init_state(o) for o in ops]
    for i in range(cfg.num_anneal):
        alpha = np.float32(i + 1.0) / np.float32(cfg.num_anneal)
        cimg_pad = [E.anneal_constraints(o, alpha) for o in ops_pad]
        early = (float(cfg.pcg_iters_early) > 0.0
                 and float(i) < float(cfg.anneal_split))
        iters = cfg.pcg_iters_early if early else cfg.pcg_iters
        for _ in range(cfg.gn_iters):
            xh = _halo(x)
            jtf, diag, s, c = [], [], [], []
            for k, o in enumerate(ops_pad):
                sk, ck = E.trig(xh[k])
                jk, dk = E.jtf_and_diag(xh[k], o, cimg_pad[k])
                jtf.append(_crop(jk))
                diag.append(_crop(dk))
                s.append(_crop(sk))
                c.append(_crop(ck))
            delta = _pcg_spatial(ops_pad, _halo(s), _halo(c), jtf, diag, cfg,
                                 iters)
            x = [x[k] + delta[k] for k in range(len(x))]
    return x


def _shard_rows(ops: ArapOperands, sl: slice, rows: slice, device
                ) -> ArapOperands:
    """Problems `sl` and image rows `rows` of a batched operand set (the
    weights keep the batch's slice only), on `device`."""
    out = {}
    for f in dataclasses.fields(ops):
        v = getattr(ops, f.name)[sl]
        if v.dim() >= 3:
            v = v[..., rows, :]
        out[f.name] = v.to(device, non_blocking=True)
    return ArapOperands(**out)


def solve_spatial(ops_batched: ArapOperands, cfg: S.SolverConfig,
                  mesh: Mesh):
    """Batched solve with the batch over 'data' and the rows over 'space'.

    ops_batched: operands with a leading batch axis on every leaf; H must
    be divisible by the 'space' size. Returns (states (B, 3, H, W), flows
    (B, 2, H, W)) on ``mesh.first``."""
    if ops_batched.mask.dim() != 3:
        raise ValueError(f"solve_spatial: operands of shape "
                         f"{tuple(ops_batched.mask.shape)}, expected (B, H, W)")
    n_space = mesh.shape["space"]
    B, H, _ = ops_batched.mask.shape
    if H % n_space:
        raise ValueError(f"solve_spatial: H = {H} is not divisible by the "
                         f"'space' axis of {n_space}")
    R = H // n_space
    xs = []
    for d, sl in enumerate(batch_slices(B, mesh.shape["data"])):
        shards = [_shard_rows(ops_batched, sl, slice(k * R, (k + 1) * R),
                              mesh.devices[d, k]) for k in range(n_space)]
        x = _solve_one_spatial(shards, cfg)
        xs.append(torch.cat([v.to(mesh.first, non_blocking=True) for v in x],
                            dim=-2))
    x = torch.cat(xs)
    return x, x[:, :2] - ops_batched.grid.to(mesh.first)
