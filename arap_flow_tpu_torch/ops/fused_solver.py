"""The whole annealed schedule as one kernel (ops/pallas_solver.py of the JAX
package): ``backend="fused"`` of ``ops.solver``.

Four parts:

- ``anneal_solve_fused_plain``: the plain torch version of the TPU kernel
  ``_solve_kernel``, batched over a leading B, in that kernel's grouping:
  x starts at (grid, 0), the Jacobi preconditioner is built once from the
  degree and the fit mask, each anneal step lerps the constraint image, each
  GN step linearises JtF and runs ``pcg_iters`` PCG iterations with the
  unfactored JtJ, then x += δ.
- ``fused_plan``: the launch plan of the CUDA kernel for (B, H, W), pure
  Python given the card's active clusters of each candidate plan:
  ``ops.pcg.pcg_plan``'s rule over this kernel's own shared-memory groups
  (s and c, r, Ap, δ, then x). ``card_plan`` fills in those counts from the
  device and caches the plan.
- ``anneal_solve_fused``: the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the thread-block-cluster kernel in
  ``csrc/fused_solver.cu`` (one cluster a problem runs the whole schedule,
  one launch a call) or raises.
- ``LAUNCHES``: the wrapper adds one each time it launches the kernel.

The TPU kernel's VMEM gate (``fits_vmem``) has no counterpart: where a
problem's state does not fit the cluster's shared memory, the cluster kernel
keeps it in device memory (the streamed plan), so no problem size is too
large for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from ._checks import check_operand, per_problem, weight_pairs
from .energy import ArapOperands
from .pcg import (PcgPlan, _group_bytes, _ptr, _raise_on, _t_signfold,
                  pcg_plan)
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


def _fused_group_bytes(rows: int, W: int) -> tuple[int, ...]:
    """Shared-memory bytes of each optional group of the fused kernel, in
    plan order: the PCG kernel's (s and c with halo rows, r, Ap, δ), then x
    (3 planes, each with halo rows)."""
    return (*_group_bytes(rows, W), 12 * rows * W + 24 * W)


def fused_plan(B: int, H: int, W: int,
               active: Callable[[PcgPlan], int]) -> PcgPlan:
    """The fused kernel's plan for B problems of H×W, given `active`: how
    many clusters of a candidate plan the card holds at once. The rule is
    ``pcg_plan``'s: the largest cluster (up to 16 CTAs) of which the card
    holds the whole batch at once, else the fewest waves; p's band in
    shared memory where it fits 16 CTAs (else the streamed plan), then the
    groups s and c, r, Ap, δ and x as far as they fit."""
    return pcg_plan(B, H, W, active, _fused_group_bytes)


def active_clusters(plan: PcgPlan, B: int, device=None) -> int:
    """How many clusters of `plan` (for B problems) the CUDA device holds at
    once (cudaOccupancyMaxActiveClusters of the fused kernel; default: the
    current device); 0 means the plan cannot run."""
    from .. import _build

    lib = _build.load("fused_solver")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        n = lib.fused_active_clusters(
            B, plan.cluster, int(plan.resident), plan.groups,
            plan.smem_bytes, ctypes.c_void_p(stream))
    if n < 0:
        _raise_on("active_clusters", lib.fused_error_string, -n)
    return n


@functools.cache
def card_plan(B: int, H: int, W: int, device) -> PcgPlan:
    """``fused_plan`` on a CUDA device: each candidate plan's active
    clusters queried there, once per (B, H, W, device)."""
    return fused_plan(B, H, W, lambda plan: active_clusters(plan, B, device))


def anneal_solve_fused(ops: ArapOperands, cfg) -> torch.Tensor:
    """x (..., 3, H, W) after the whole uniform schedule of `cfg`, for
    unbatched or batched operands. CPU tensors run the plain version; CUDA
    tensors run the cluster kernel with ``card_plan``'s plan on the current
    stream, one launch a call, without synchronising."""
    unbatched = ops.mask.dim() == 2
    if unbatched:
        ops = ArapOperands(**{k: v[None] for k, v in vars(ops).items()})
    dev = ops.mask.device
    if dev.type == "cpu":
        x = anneal_solve_fused_plain(ops, cfg)
        return x[0] if unbatched else x
    if dev.type != "cuda":
        raise ValueError(f"anneal_solve_fused: no kernel for device {dev}")
    num_anneal, gn_iters, pcg_iters = schedule(cfg)
    if min(num_anneal, gn_iters, pcg_iters) < 0:
        raise ValueError(f"anneal_solve_fused: schedule {num_anneal}x"
                         f"{gn_iters}x{pcg_iters}")
    from .. import _build

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
    plan = card_plan(B, H, W, dev)
    x = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
    pre = torch.empty((B, 2, H, W), dtype=torch.float32, device=dev)
    # device-memory scratch for the planes the plan keeps off the chip
    sc = torch.empty_like(pre) if plan.groups < 1 else None
    r, ap, delta = (torch.empty_like(x) if plan.groups < g else None
                    for g in (2, 3, 4))
    p = None if plan.resident else torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_solve_f32(
            *(_ptr(t) for t in (vm, fit, csrc, ctgt, grid, w, x, pre, sc, r,
                                p, ap, delta)),
            B, H, W, num_anneal, gn_iters, pcg_iters, plan.cluster,
            plan.rows_per_cta, int(plan.resident), plan.groups,
            plan.smem_bytes, ctypes.c_void_p(stream),
        )
    _raise_on("anneal_solve_fused", lib.fused_error_string, err)
    LAUNCHES["anneal_solve_fused"] += 1
    return x[0] if unbatched else x
