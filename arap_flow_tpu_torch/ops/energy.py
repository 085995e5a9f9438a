"""The ARAP image-deformation energy and its Gauss-Newton operators
(ops/energy.py of the JAX package, whose module docstring derives every
formula below).

Per pixel i: unknowns o_i (warped position, 2 channels) and a_i (angle);
x = [ox, oy, a] is a (..., 3, H, W) float tensor. Residuals are the masked
4-neighbour regularisers w_reg·((o_i − o_j) − R(a_i)(u_i − u_j)) and the fit
terms w_fit·(o_i − c_i) on constrained pixels.

Every operator takes any leading batch shape: an unbatched problem has
(H, W) planes and 0-d weights, a batch of B problems (B, H, W) planes and
(B,) weights (the JAX package's ``vmap`` written out as a leading
dimension). Operands are built on the host with numpy and shipped once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils import transfer
from .stencil import DIRS, shift


class ArapWeights(NamedTuple):
    """Energy weights: the operands carry wf2 = w_fit and wr2 = w_reg, the
    squares of the residual weights w_fitSqrt / w_regSqrt."""

    w_fit: float = 100.0
    w_reg: float = 0.01


@dataclass
class ArapOperands:
    """Per-solve constant operands; the JAX ``ArapOperands`` as tensors.

    mask (..., H, W) ∈ {0,1} with 1 = solve region; vmasks (..., 4, H, W)
    direction masks v_dir = mask·shift(mask, dir) in ``DIRS`` order; degree
    (..., H, W) = Σ_dir v_dir; con_src / con_tgt (..., 2, H, W) constraint
    source / target positions; fitmask (..., H, W) ∈ {0,1}; grid
    (..., 2, H, W) integer pixel coordinates (x, y); wf2 / wr2 of the batch
    shape.
    """

    mask: torch.Tensor
    vmasks: torch.Tensor
    degree: torch.Tensor
    con_src: torch.Tensor
    con_tgt: torch.Tensor
    fitmask: torch.Tensor
    grid: torch.Tensor
    wf2: torch.Tensor
    wr2: torch.Tensor


NO_CONSTRAINT = -32768  # int16 min: "no constraint" in CompactOperands


@dataclass
class CompactOperands:
    """Upload-efficient problem encoding (the JAX ``CompactOperands``).

    mask_u8 (..., H, W) uint8 raw ARAP mask (0 = solve region); con_tgt_i16
    (..., 2, H, W) int16 constraint target per source pixel, NO_CONSTRAINT
    where there is none; wf2 / wr2 float32 of the batch shape. Leaves are
    host numpy arrays from ``build_compact``; ``to`` ships them to a device
    and ``expand_operands`` derives the full operands there.
    """

    mask_u8: np.ndarray | torch.Tensor
    con_tgt_i16: np.ndarray | torch.Tensor
    wf2: np.ndarray | torch.Tensor
    wr2: np.ndarray | torch.Tensor

    def to(self, device) -> "CompactOperands":
        """The leaves on `device`, uploaded without waiting for the device
        (``utils.transfer.upload``)."""
        return CompactOperands(**{
            f.name: transfer.upload(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })

    @staticmethod
    def stack(items: list["CompactOperands"]) -> "CompactOperands":
        """Host-side stack of per-problem numpy leaves into one batch."""
        return CompactOperands(**{
            f.name: np.stack([np.asarray(getattr(c, f.name)) for c in items])
            for f in dataclasses.fields(CompactOperands)
        })


def operands_from_numpy(leaves, device) -> ArapOperands | CompactOperands:
    """The JAX package's ``ArapOperands`` / ``CompactOperands`` leaves, given
    as numpy arrays (a mapping or a NamedTuple), as the port's operands on
    `device` — so both packages solve the identical problem."""
    if hasattr(leaves, "_asdict"):
        leaves = leaves._asdict()
    names = set(leaves)
    for cls in (ArapOperands, CompactOperands):
        fields = {f.name for f in dataclasses.fields(cls)}
        if names == fields:
            break
    else:
        raise ValueError(f"not an operand set: {sorted(names)}")
    if cls is CompactOperands:
        return CompactOperands(**{k: np.asarray(v) for k, v in leaves.items()}
                               ).to(device)
    return ArapOperands(**{
        k: torch.tensor(np.asarray(v), device=device)
        for k, v in leaves.items()
    })


def _pw(w: torch.Tensor) -> torch.Tensor:
    """A batch-shaped weight broadcast against (..., H, W) planes."""
    return w[..., None, None]


def make_grid(H: int, W: int, device, dtype=torch.float32) -> torch.Tensor:
    """UrShape image: (2, H, W) with channel 0 = x (column), 1 = y (row)."""
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys])


def build_operands(arap_mask, constraints, weights: ArapWeights = ArapWeights(),
                   *, device, dtype=None) -> ArapOperands:
    """Solve-time operands from an ARAP mask (0 = solve region) and an (N, 4)
    constraint list (x1, y1, x2, y2) that already carries the border pins.
    Host numpy, then one upload; later duplicate constraints win. `dtype`
    is the numpy solve precision, float32 (default) or float64."""
    dtype = np.dtype(dtype or np.float32)
    arap_mask = np.asarray(arap_mask)
    H, W = arap_mask.shape
    m = (arap_mask == 0).astype(dtype)

    def _shift_np(a, dy, dx):
        out = np.zeros_like(a)
        ys = slice(max(dy, 0), H + min(dy, 0))
        yd = slice(max(-dy, 0), H + min(-dy, 0))
        xs = slice(max(dx, 0), W + min(dx, 0))
        xd = slice(max(-dx, 0), W + min(-dx, 0))
        out[yd, xd] = a[ys, xs]
        return out

    vmasks = np.stack([m * _shift_np(m, dy, dx) for dy, dx in DIRS])
    con_src = np.zeros((2, H, W), dtype)
    con_tgt = np.zeros((2, H, W), dtype)
    fit = np.zeros((H, W), dtype)
    constraints = np.asarray(constraints, np.int64).reshape(-1, 4)
    if constraints.shape[0]:
        x1, y1, x2, y2 = (constraints[:, k] for k in range(4))
        con_src[0, y1, x1] = x1
        con_src[1, y1, x1] = y1
        con_tgt[0, y1, x1] = x2
        con_tgt[1, y1, x1] = y2
        fit[y1, x1] = 1.0
    fit = fit * m
    gx, gy = np.meshgrid(np.arange(W, dtype=dtype), np.arange(H, dtype=dtype))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return ArapOperands(
        mask=t(m), vmasks=t(vmasks), degree=t(vmasks.sum(0)),
        con_src=t(con_src), con_tgt=t(con_tgt), fitmask=t(fit),
        grid=t(np.stack([gx, gy])),
        wf2=t(weights.w_fit), wr2=t(weights.w_reg),
    )


def build_compact(arap_mask, constraints,
                  weights: ArapWeights = ArapWeights()) -> CompactOperands:
    """Host-side compact encoding; ``expand_operands`` of it equals
    ``build_operands`` on every gating plane and every fit-active pixel."""
    arap_mask = np.ascontiguousarray(arap_mask, dtype=np.uint8)
    H, W = arap_mask.shape
    tgt = np.full((2, H, W), NO_CONSTRAINT, np.int16)
    constraints = np.asarray(constraints, np.int64).reshape(-1, 4)
    if constraints.shape[0]:
        x1, y1, x2, y2 = (constraints[:, k] for k in range(4))
        tgt[0, y1, x1] = x2
        tgt[1, y1, x1] = y2
    return CompactOperands(
        mask_u8=arap_mask,
        con_tgt_i16=tgt,
        wf2=np.float32(weights.w_fit),
        wr2=np.float32(weights.w_reg),
    )


def expand_operands(c: CompactOperands) -> ArapOperands:
    """Derive the full operands on the device the compact leaves lie on."""
    if not isinstance(c.mask_u8, torch.Tensor):
        raise TypeError("expand_operands needs tensor leaves: call .to(device)")
    H, W = c.mask_u8.shape[-2:]
    m = (c.mask_u8 == 0).to(torch.float32)
    vmasks = torch.stack([m * shift(m, dy, dx) for dy, dx in DIRS], dim=-3)
    grid = make_grid(H, W, m.device)
    fit = (c.con_tgt_i16[..., 0, :, :] != NO_CONSTRAINT).to(torch.float32) * m
    fit3 = fit.unsqueeze(-3)
    return ArapOperands(
        mask=m,
        vmasks=vmasks,
        degree=vmasks.sum(-3),
        con_src=grid * fit3,
        con_tgt=c.con_tgt_i16.to(torch.float32) * fit3,
        fitmask=fit,
        grid=grid.expand(*m.shape[:-2], 2, H, W).contiguous(),
        wf2=c.wf2.to(torch.float32),
        wr2=c.wr2.to(torch.float32),
    )


def anneal_constraints(ops: ArapOperands, alpha: float) -> torch.Tensor:
    """Annealed constraint image (..., 2, H, W): lerp source -> target.
    `alpha` is a float32 value; 1 − alpha is taken in float32 as well."""
    a = np.float32(alpha)
    return float(np.float32(1.0) - a) * ops.con_src + float(a) * ops.con_tgt


def init_state(ops: ArapOperands) -> torch.Tensor:
    """Initial unknowns x = [grid, angle = 0] (..., 3, H, W)."""
    zeros = torch.zeros_like(ops.grid[..., :1, :, :])
    return torch.cat([ops.grid, zeros], dim=-3)


def trig(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin a, cos a) planes of the state; fixed across one GN linear solve."""
    return torch.sin(x[..., 2, :, :]), torch.cos(x[..., 2, :, :])


def _t_dir(s, c, dy: int, dx: int):
    """t_dir = ∂(−R(a)(u_i − u_j))/∂a = (−dx·s − dy·c, dx·c − dy·s)."""
    return (-dx) * s - dy * c, dx * c - dy * s


def residuals(x: torch.Tensor, ops: ArapOperands,
              cimg: torch.Tensor) -> torch.Tensor:
    """All scalar residuals stacked: (..., 10, H, W) = 4 dirs × 2 + fit × 2."""
    o = x[..., :2, :, :]
    s, c = trig(x)
    wr = _pw(torch.sqrt(ops.wr2))
    wf = _pw(torch.sqrt(ops.wf2))
    parts = []
    for k, (dy, dx) in enumerate(DIRS):
        oj = shift(o, dy, dx)
        ex = o[..., 0, :, :] - oj[..., 0, :, :] + (dx * c - dy * s)
        ey = o[..., 1, :, :] - oj[..., 1, :, :] + (dx * s + dy * c)
        v = ops.vmasks[..., k, :, :]
        parts.append((wr * v).unsqueeze(-3) * torch.stack([ex, ey], dim=-3))
    parts.append((wf * ops.fitmask).unsqueeze(-3) * (o - cimg))
    return torch.cat(parts, dim=-3)


def cost(x: torch.Tensor, ops: ArapOperands, cimg: torch.Tensor) -> torch.Tensor:
    """Total energy ½ Σ r² per problem (batch-shaped)."""
    r = residuals(x, ops, cimg)
    return 0.5 * torch.sum(r * r, dim=(-3, -2, -1))


def jtf_and_diag(x: torch.Tensor, ops: ArapOperands, cimg: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient JtF and the Jacobi diagonal of JtJ, both (..., 3, H, W)."""
    o = x[..., :2, :, :]
    ox, oy = o[..., 0, :, :], o[..., 1, :, :]
    s, c = trig(x)
    g_o = torch.zeros_like(o)
    g_a = torch.zeros_like(s)
    for k, (dy, dx) in enumerate(DIRS):
        v = ops.vmasks[..., k, :, :]
        oj = shift(o, dy, dx)
        ojx, ojy = oj[..., 0, :, :], oj[..., 1, :, :]
        ex = ox - ojx + (dx * c - dy * s)
        ey = oy - ojy + (dx * s + dy * c)
        # the neighbour's opposite-direction residual evaluated at j = i + dir
        sj, cj = shift(s, dy, dx), shift(c, dy, dx)
        exn = ojx - ox - (dx * cj - dy * sj)
        eyn = ojy - oy - (dx * sj + dy * cj)
        tx, ty = _t_dir(s, c, dy, dx)
        g_o = g_o + v.unsqueeze(-3) * torch.stack([ex - exn, ey - eyn], dim=-3)
        g_a = g_a + v * (tx * ex + ty * ey)
    wr2, wf2 = _pw(ops.wr2), _pw(ops.wf2)
    jtf = torch.cat([
        wr2.unsqueeze(-3) * g_o + (wf2 * ops.fitmask).unsqueeze(-3) * (o - cimg),
        (wr2 * g_a).unsqueeze(-3),
    ], dim=-3)
    diag_o = _pw(2.0 * ops.wr2) * ops.degree + wf2 * ops.fitmask
    diag_a = wr2 * ops.degree
    return jtf, torch.stack([diag_o, diag_o, diag_a], dim=-3)


def apply_jtj(p: torch.Tensor, ops: ArapOperands, s: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Matrix-free JtJ·p (..., 3, H, W) at the linearisation point (s, c)."""
    po = p[..., :2, :, :]
    pa = p[..., 2, :, :]
    wr2, wf2 = _pw(ops.wr2), _pw(ops.wf2)
    out_o = (wf2 * ops.fitmask).unsqueeze(-3) * po
    acc_x = torch.zeros_like(pa)
    acc_y = torch.zeros_like(pa)
    acc_a = torch.zeros_like(pa)
    for k, (dy, dx) in enumerate(DIRS):
        v = ops.vmasks[..., k, :, :]
        poj = shift(po, dy, dx)
        paj = shift(pa, dy, dx)
        sj, cj = shift(s, dy, dx), shift(c, dy, dx)
        tx, ty = _t_dir(s, c, dy, dx)
        txj, tyj = _t_dir(sj, cj, dy, dx)
        dox = po[..., 0, :, :] - poj[..., 0, :, :]
        doy = po[..., 1, :, :] - poj[..., 1, :, :]
        acc_x = acc_x + v * (2.0 * dox + pa * tx + paj * txj)
        acc_y = acc_y + v * (2.0 * doy + pa * ty + paj * tyj)
        acc_a = acc_a + v * (tx * dox + ty * doy + pa)
    acc_o = torch.stack([acc_x, acc_y], dim=-3)
    return torch.cat(
        [out_o + wr2.unsqueeze(-3) * acc_o, (wr2 * acc_a).unsqueeze(-3)], dim=-3
    )


def sparse_jacobian(x: torch.Tensor, ops: ArapOperands, cimg: torch.Tensor):
    """The residuals' Jacobian as numpy COO (rows, cols, vals): the dumpJ
    export, computed on the host.

    Rows index the 10 residual planes of ``residuals`` (4 directions × 2
    components, then the 2 fit components), row = plane·H·W + y·W + x;
    columns index the unknowns, col = channel·H·W + y·W + x with channels
    (offset_x, offset_y, angle). Entries that are structurally zero (masked
    residuals) are dropped. A batch of B problems gives the block-diagonal
    Jacobian: problem k's rows are offset by k·10·H·W and its columns by
    k·3·H·W. `cimg` does not enter the Jacobian; it is taken for the
    operators' signature.
    """
    if x.dim() == 4:
        parts, HW = [], x.shape[-2] * x.shape[-1]
        for k in range(x.shape[0]):
            ops_k = ArapOperands(**{f: v[k] for f, v in vars(ops).items()})
            r, c, v = sparse_jacobian(x[k], ops_k, cimg[k])
            parts.append((r + k * 10 * HW, c + k * 3 * HW, v))
        return tuple(np.concatenate(p) for p in zip(*parts))
    xn = x.detach().cpu().numpy()
    H, W = xn.shape[-2:]
    HW = H * W
    s, c = np.sin(xn[2]), np.cos(xn[2])
    wr = float(np.sqrt(ops.wr2.detach().cpu().numpy()))
    wf = float(np.sqrt(ops.wf2.detach().cpu().numpy()))
    vmasks = ops.vmasks.detach().cpu().numpy()
    fit = ops.fitmask.detach().cpu().numpy()
    pix = np.arange(HW, dtype=np.int64).reshape(H, W)
    rows_l, cols_l, vals_l = [], [], []

    def emit(row, col, val):
        rows_l.append(row.ravel())
        cols_l.append(col.ravel())
        vals_l.append(val.ravel())

    yy, xx = np.mgrid[0:H, 0:W]
    for k, (dy, dx) in enumerate(DIRS):
        v = vmasks[k]
        jpix = np.clip(yy + dy, 0, H - 1) * W + np.clip(xx + dx, 0, W - 1)
        tx, ty = _t_dir(s, c, dy, dx)
        for comp, t_a in ((0, tx), (1, ty)):
            row = (2 * k + comp) * HW + pix
            emit(row, comp * HW + pix, wr * v)        # ∂/∂o_i
            emit(row, comp * HW + jpix, -wr * v)      # ∂/∂o_j
            emit(row, 2 * HW + pix, wr * v * t_a)     # ∂/∂a_i
    for comp in (0, 1):
        emit((8 + comp) * HW + pix, comp * HW + pix, wf * fit)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l).astype(xn.dtype)
    keep = vals != 0.0
    return rows[keep], cols[keep], vals[keep]
