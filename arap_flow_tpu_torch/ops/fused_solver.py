"""The whole annealed schedule as one kernel (ops/pallas_solver.py of the JAX
package): ``backend="fused"`` of ``ops.solver``.

Three parts:

- ``anneal_solve_fused_plain``: the plain torch version of the TPU kernel
  ``_solve_kernel``, batched over a leading B, in that kernel's grouping:
  x starts at (grid, 0), the Jacobi preconditioner is built once from the
  degree and the fit mask, each anneal step lerps the constraint image, each
  GN step linearises JtF and runs ``pcg_iters`` PCG iterations with the
  unfactored JtJ, then x += δ.
- ``anneal_solve_fused``: the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the persistent cooperative kernel in
  ``csrc/fused_solver.cu`` (one launch per call) or raises.
- ``LAUNCHES``: the wrapper adds one each time it launches the kernel.

The TPU kernel's VMEM gate (``fits_vmem``) has no counterpart: the
cooperative kernel keeps its state in device memory, so no problem size is
too large for it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._checks import check_operand, per_problem, weight_pairs
from .energy import ArapOperands
from .pcg import _t_signfold
from .stencil import DIRS, shift

LAUNCHES: dict[str, int] = {"anneal_solve_fused": 0}


def schedule(cfg) -> tuple[int, int, int]:
    """(num_anneal, gn_iters, PCG iterations a GN step) of a uniform
    schedule: the budget row min(max_pcg_iters, int(pcg_iters))."""
    return (int(cfg.num_anneal), int(cfg.gn_iters),
            min(int(cfg.max_pcg_iters), int(cfg.pcg_iters)))


def _jtf(x, s, c, cimg, vm, wfit, wr2):
    """JtF at x (the TPU kernel's linearisation, :83-102), (B, 3, H, W)."""
    ox, oy = x[:, 0], x[:, 1]
    gx = wfit * (ox - cimg[:, 0])
    gy = wfit * (oy - cimg[:, 1])
    ga = torch.zeros_like(s)
    for k, (dy, dx) in enumerate(DIRS):
        wv = wr2 * vm[k]
        oxj, oyj = shift(ox, dy, dx), shift(oy, dy, dx)
        sj, cj = shift(s, dy, dx), shift(c, dy, dx)
        ex = ox - oxj + (dx * c - dy * s)
        ey = oy - oyj + (dx * s + dy * c)
        exn = oxj - ox - (dx * cj - dy * sj)
        eyn = oyj - oy - (dx * sj + dy * cj)
        tx, ty = _t_signfold(dy, dx, s, c)
        gx = gx + wv * (ex - exn)
        gy = gy + wv * (ey - eyn)
        ga = ga + wv * (tx * ex + ty * ey)
    return torch.stack([gx, gy, ga], dim=1)


def _jtj_unfactored(p, s, c, vm, wfit, wr2):
    """JtJ·p in the TPU kernel's unfactored form (:112-146), (B, 3, H, W)."""
    px, py, pa = p.unbind(1)
    ax = wfit * px
    ay = wfit * py
    aa = torch.zeros_like(px)
    accx = torch.zeros_like(px)
    accy = torch.zeros_like(px)
    for k, (dy, dx) in enumerate(DIRS):
        v = vm[k]
        poxj, poyj = shift(px, dy, dx), shift(py, dy, dx)
        paj = shift(pa, dy, dx)
        tx, ty = _t_signfold(dy, dx, s, c)
        txj, tyj = _t_signfold(dy, dx, shift(s, dy, dx), shift(c, dy, dx))
        dox = px - poxj
        doy = py - poyj
        accx = accx + v * (2.0 * dox + pa * tx + paj * txj)
        accy = accy + v * (2.0 * doy + pa * ty + paj * tyj)
        aa = aa + wr2 * v * (tx * dox + ty * doy + pa)
    return torch.stack([ax + wr2 * accx, ay + wr2 * accy, aa], dim=1)


def _sum3(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t, dim=(1, 2, 3))


def anneal_solve_fused_plain(ops: ArapOperands, cfg) -> torch.Tensor:
    """x (B, 3, H, W) after the whole uniform schedule of `cfg` on batched
    operands (every leaf with a leading B; weights 0-d or (B,))."""
    num_anneal, gn_iters, pcg_iters = schedule(cfg)
    B = ops.mask.shape[0]
    wf2, wr2 = (per_problem(w, B, w.device, dtype=None)[:, None, None]
                for w in (ops.wf2, ops.wr2))
    vm = list(ops.vmasks.unbind(1))
    wfit = wf2 * ops.fitmask
    x = torch.cat([ops.grid, torch.zeros_like(ops.grid[:, :1])], dim=1)
    degree = vm[0] + vm[1] + vm[2] + vm[3]
    pre_o = 1.0 / torch.square(1.0 + torch.sqrt(2.0 * wr2 * degree + wfit))
    pre_a = 1.0 / torch.square(1.0 + torch.sqrt(wr2 * degree))
    pre = torch.stack([pre_o, pre_o, pre_a], dim=1)
    for i in range(num_anneal):
        alpha = np.float32(i + 1.0) / np.float32(num_anneal)
        cimg = (float(np.float32(1.0) - alpha) * ops.con_src
                + float(alpha) * ops.con_tgt)
        for _ in range(gn_iters):
            s, c = torch.sin(x[:, 2]), torch.cos(x[:, 2])
            r = -_jtf(x, s, c, cimg, vm, wfit, wr2)
            p = pre * r
            delta = torch.zeros_like(r)
            rz = _sum3(r * p)
            for _ in range(pcg_iters):
                ap = _jtj_unfactored(p, s, c, vm, wfit, wr2)
                pap = _sum3(p * ap)
                a = torch.where(pap > 0.0, rz / pap, 0.0)[:, None, None, None]
                delta = delta + a * p
                r = r - a * ap
                z = pre * r
                rz_new = _sum3(z * r)
                beta = torch.where(rz > 0.0, rz_new / rz, 0.0)
                p = z + beta[:, None, None, None] * p
                rz = rz_new
            x = x + delta
    return x


def anneal_solve_fused(ops: ArapOperands, cfg) -> torch.Tensor:
    """x (..., 3, H, W) after the whole uniform schedule of `cfg`, for
    unbatched or batched operands. CPU tensors run the plain version; CUDA
    tensors run the cooperative kernel on the current stream, one launch a
    call, without synchronising."""
    unbatched = ops.mask.dim() == 2
    if unbatched:
        ops = ArapOperands(**{k: v[None] for k, v in vars(ops).items()})
    dev = ops.mask.device
    if dev.type == "cpu":
        x = anneal_solve_fused_plain(ops, cfg)
        return x[0] if unbatched else x
    if dev.type != "cuda":
        raise ValueError(f"anneal_solve_fused: no kernel for device {dev}")
    from .. import _build

    num_anneal, gn_iters, pcg_iters = schedule(cfg)
    if min(num_anneal, gn_iters, pcg_iters) < 0:
        raise ValueError(f"anneal_solve_fused: schedule {num_anneal}x"
                         f"{gn_iters}x{pcg_iters}")
    B, H, W = ops.mask.shape
    w = weight_pairs(ops.wf2, ops.wr2, B, dev)
    ins = {"vmasks": (ops.vmasks, (B, 4, H, W)),
           "fitmask": (ops.fitmask, (B, H, W)),
           "con_src": (ops.con_src, (B, 2, H, W)),
           "con_tgt": (ops.con_tgt, (B, 2, H, W)),
           "grid": (ops.grid, (B, 2, H, W)), "w": (w, (B, 2))}
    for name, (t, shape) in ins.items():
        check_operand("anneal_solve_fused", name, t, dev, shape)
    vm, fit, csrc, ctgt, grid, w = (t for t, _ in ins.values())

    lib = _build.load("fused_solver")
    x = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
    sc, pre = (torch.empty((B, 2, H, W), dtype=torch.float32, device=dev)
               for _ in range(2))
    delta, r, p, ap = (torch.empty_like(x) for _ in range(4))
    part = torch.empty((3, B, lib.fused_solve_nchunk(H, W)),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_solve_f32(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                vm, fit, csrc, ctgt, grid, w, x, sc, pre, delta, r, p, ap,
                part)),
            B, H, W, num_anneal, gn_iters, pcg_iters, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"anneal_solve_fused: CUDA error {err}: "
                           f"{lib.fused_error_string(err).decode()}")
    LAUNCHES["anneal_solve_fused"] += 1
    return x[0] if unbatched else x
