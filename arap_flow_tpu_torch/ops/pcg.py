"""Fixed-count Jacobi-PCG for the ARAP GN system (ops/pallas_pcg.py of the
JAX package): the kernel of the per-GN solve and of ``solve_batch``.

Four parts:

- ``pcg_fixed_plain``: the plain torch version, batched over B problems with
  per-problem weights, the same math as the TPU kernels ``_pcg_kernel`` and
  ``_pcg_kernel_batched`` (loop-constant planes of
  ``_precompute_const_planes`` + the factored JtJ of ``_jtj_factored``).
- ``pcg_plan``: the launch plan of the CUDA kernel for (B, H, W), pure
  Python: the thread-block cluster per problem, the rows each CTA owns,
  and which planes live in shared memory.
- ``pcg_fixed``: the wrapper. A CPU tensor goes to ``pcg_fixed_plain``; a
  CUDA tensor goes to the cluster kernel in ``csrc/pcg.cu`` (built on first
  use by ``_build``), one launch a call, or raises. There is no fallback
  between them.
- ``LAUNCHES``: launch counts per kernel; the wrapper adds one each time it
  launches the CUDA kernel (one call runs all ``iters`` iterations).

The tall layout (``ARAP_TALL_KERNEL``, the TPU's ``pcg_pallas_tall`` and
``pcg_pallas_batched_tall``) is a template flag of the same kernel that
reads p as one stacked (3H, W) plane per problem; ``tall=None`` reads the
variable at call time. It is counted as ``pcg_fixed_tall``.

``_pcg_fixed_three_pass`` launches the earlier three-pass form of the
kernel (1 + 3·iters launches a call), kept only as a yardstick for
``chip_smoke.py``; no solver route reaches it and it is not counted.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ._checks import check_operand, per_problem, weight_pairs
from .stencil import DIRS, shift

LAUNCHES: dict[str, int] = {"pcg_fixed": 0, "pcg_fixed_tall": 0}

# The card the plan is made for (an H100): shared memory one block can use,
# of which the kernel's own static arrays take under 1 KB, and its SMs.
SMEM_PER_BLOCK = 232_448
_STATIC_SMEM = 1024
SMS = 132
MAX_CLUSTER = 16


class PcgPlan(NamedTuple):
    """Launch plan of the cluster kernel: `cluster` CTAs per problem, CTA k
    owning rows [k·rows_per_cta, (k + 1)·rows_per_cta) ∩ [0, H); p's band
    in shared memory when `resident` (else the streamed plan: p in device
    memory), beside the halo rows of p that the neighbours push; `groups`
    of (s and c with halo rows, r, Ap, δ) also in shared memory, in that
    order; `smem_bytes` of dynamic shared memory a CTA."""

    cluster: int
    rows_per_cta: int
    resident: bool
    smem_bytes: int
    groups: int


def _group_bytes(rows: int, W: int) -> tuple[int, ...]:
    """Shared-memory bytes of each optional group, in plan order."""
    band = 4 * rows * W
    return 2 * (band + 8 * W), 3 * band, 3 * band, 3 * band


def pcg_plan(B: int, H: int, W: int) -> PcgPlan:
    """The cluster kernel's plan for B problems of H×W.

    The cluster is the smallest (1..16) whose band of p (3 floats a pixel)
    fits a block's shared memory: the resident plan. It is then raised
    toward SMS // B, so that the batch's B·cluster CTAs cover the card's
    132 SMs, but never above 16. Where p does not fit 16 CTAs the plan is
    streamed, with 16. The rows are split evenly (the last band may be
    shorter), and the cluster is trimmed so that no CTA is left without
    rows. The groups then fill the shared memory that is left, in order,
    until the next one does not fit (the streamed plan keeps none)."""
    budget = SMEM_PER_BLOCK - _STATIC_SMEM
    fits = [c for c in range(1, MAX_CLUSTER + 1)
            if 24 * W + 12 * -(-H // c) * W <= budget]
    resident = bool(fits)
    cluster = (min(MAX_CLUSTER, max(fits[0], SMS // max(B, 1))) if resident
               else MAX_CLUSTER)
    rows = -(-H // cluster)
    cluster = -(-H // rows)
    # the halo rows of p above and below the band, then p's band
    smem = 24 * W + (12 * rows * W if resident else 0)
    groups = 0
    for nbytes in _group_bytes(rows, W) if resident else ():
        if smem + nbytes > budget:
            break
        smem += nbytes
        groups += 1
    return PcgPlan(cluster, rows, resident, smem, groups)


def tall_kernel_enabled() -> bool:
    """The ARAP_TALL_KERNEL flag (the stacked-plane layout), read at call
    time: set and not "", "0" or "off"."""
    return os.environ.get("ARAP_TALL_KERNEL", "") not in ("", "0", "off")


def _t_signfold(dy: int, dx: int, sv, cv):
    """t_dir for a unit direction with its 0/±1 factors folded."""
    if (dy, dx) == (0, 1):
        return -sv, cv
    if (dy, dx) == (0, -1):
        return sv, -cv
    if (dy, dx) == (1, 0):
        return -cv, -sv
    return cv, sv  # (-1, 0)


def _const_planes(s, c, vm, fit, wf2, wr2):
    """Loop-constant planes of the factored JtJ (gx[4], gy[4], fitw, TxW, TyW,
    degw); `vm` is the list of 4 direction masks, wf2/wr2 broadcast."""
    gx, gy = [], []
    for k, (dy, dx) in enumerate(DIRS):
        txj, tyj = _t_signfold(dy, dx, shift(s, dy, dx), shift(c, dy, dx))
        gx.append(wr2 * vm[k] * txj)
        gy.append(wr2 * vm[k] * tyj)
    v0, v1, v2, v3 = vm
    fitw = wf2 * fit
    TxW = wr2 * (s * (v1 - v0) + c * (v3 - v2))
    TyW = wr2 * (c * (v0 - v1) + s * (v3 - v2))
    degw = wr2 * ((v0 + v1) + (v2 + v3))
    return gx, gy, fitw, TxW, TyW, degw


def _jtj_factored(px, py, pa, s, c, vm, gx, gy, fitw, TxW, TyW, degw, wr2):
    """JtJ·p in the factored form. The neighbour differences come first,
    v·(px − pxj): regrouping them as deg·px − Σ v·pxj cancels two large
    products and measurably degrades the truncated 400-iteration solve."""
    d = [vm[k] * (px - shift(px, dy, dx)) for k, (dy, dx) in enumerate(DIRS)]
    e = [vm[k] * (py - shift(py, dy, dx)) for k, (dy, dx) in enumerate(DIRS)]
    paj = [shift(pa, dy, dx) for dy, dx in DIRS]
    Lx = (d[0] + d[1]) + (d[2] + d[3])
    Ly = (e[0] + e[1]) + (e[2] + e[3])
    Ax = s * (d[1] - d[0]) + c * (d[3] - d[2])
    Ay = c * (e[0] - e[1]) + s * (e[3] - e[2])
    Gx = (gx[0] * paj[0] + gx[1] * paj[1]) + (gx[2] * paj[2] + gx[3] * paj[3])
    Gy = (gy[0] * paj[0] + gy[1] * paj[1]) + (gy[2] * paj[2] + gy[3] * paj[3])
    apx = fitw * px + (2.0 * wr2) * Lx + TxW * pa + Gx
    apy = fitw * py + (2.0 * wr2) * Ly + TyW * pa + Gy
    apa = wr2 * (Ax + Ay) + degw * pa
    return apx, apy, apa


def pcg_fixed_plain(b, pre, s, c, vmasks, fitmask, wf2, wr2,
                    iters: int) -> torch.Tensor:
    """δ (B,3,H,W) after `iters` Jacobi-PCG iterations on JtJ δ = b.

    b, pre (B,3,H,W); s, c, fitmask (B,H,W); vmasks (B,4,H,W); wf2, wr2
    scalars or (B,) per-problem weights. This is the plain version of both
    layouts of the kernel: in plain torch the tall layout changes nothing."""
    B = b.shape[0]
    wf2, wr2 = (per_problem(w, B, b.device)[:, None, None] for w in (wf2, wr2))
    vm = list(vmasks.unbind(1))
    gx, gy, fitw, TxW, TyW, degw = _const_planes(s, c, vm, fitmask, wf2, wr2)
    r = b
    z = pre * r
    p = z
    delta = torch.zeros_like(b)
    rz = torch.sum(r * z, dim=(1, 2, 3))
    for _ in range(int(iters)):
        px, py, pa = p.unbind(1)
        apx, apy, apa = _jtj_factored(px, py, pa, s, c, vm, gx, gy, fitw,
                                      TxW, TyW, degw, wr2)
        pap = torch.sum(px * apx + py * apy + pa * apa, dim=(1, 2))
        alpha = torch.where(pap > 0.0, rz / pap, 0.0)[:, None, None, None]
        delta = delta + alpha * p
        r = r - alpha * torch.stack([apx, apy, apa], dim=1)
        z = pre * r
        rz_new = torch.sum(
            z[:, 0] * r[:, 0] + z[:, 1] * r[:, 1] + z[:, 2] * r[:, 2],
            dim=(1, 2),
        )
        beta = torch.where(rz > 0.0, rz_new / rz, 0.0)[:, None, None, None]
        p = z + beta * p
        rz = rz_new
    return delta


def _kernel_operands(fn, b, pre, s, c, vmasks, fitmask, wf2, wr2, iters):
    """Check the CUDA kernels' operands; returns (B, H, W, iters, w)."""
    B, three, H, W = b.shape
    if three != 3:
        raise ValueError(f"{fn}: b has shape {tuple(b.shape)}")
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"{fn}: iters = {iters}")
    dev = b.device
    w = weight_pairs(wf2, wr2, B, dev)
    for name, t, shape in (
        ("b", b, (B, 3, H, W)), ("pre", pre, (B, 3, H, W)),
        ("s", s, (B, H, W)), ("c", c, (B, H, W)),
        ("vmasks", vmasks, (B, 4, H, W)), ("fitmask", fitmask, (B, H, W)),
        ("w", w, (B, 2)),
    ):
        check_operand(fn, name, t, dev, shape)
    return B, H, W, iters, w


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _raise_on(fn: str, lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{fn}: CUDA error {err}: {lib.pcg_error_string(err).decode()}")


def pcg_fixed(b, pre, s, c, vmasks, fitmask, wf2, wr2, iters: int,
              tall: bool | None = None) -> torch.Tensor:
    """δ (B,3,H,W) after `iters` PCG iterations (see ``pcg_fixed_plain`` for
    the arguments). CPU tensors run the plain version; CUDA tensors run the
    cluster kernel in one launch on the current stream, without
    synchronising, with ``pcg_plan``'s plan, in the tall layout when `tall`
    (None: ``tall_kernel_enabled()``)."""
    if b.device.type == "cpu":
        return pcg_fixed_plain(b, pre, s, c, vmasks, fitmask, wf2, wr2, iters)
    if b.device.type != "cuda":
        raise ValueError(f"pcg_fixed: no kernel for device {b.device}")
    from .. import _build

    B, H, W, iters, w = _kernel_operands("pcg_fixed", b, pre, s, c, vmasks,
                                         fitmask, wf2, wr2, iters)
    tall = tall_kernel_enabled() if tall is None else bool(tall)
    plan = pcg_plan(B, H, W)
    lib = _build.load("pcg")
    delta = torch.empty_like(b)
    # device-memory scratch for the planes the plan keeps off the chip
    r = torch.empty_like(b) if plan.groups < 2 else None
    ap = torch.empty_like(b) if plan.groups < 3 else None
    p = None if plan.resident else torch.empty_like(b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.pcg_fixed_f32(
            *(_ptr(t) for t in (b, pre, s, c, vmasks, fitmask, w, delta, r,
                                p, ap)),
            B, H, W, iters, int(tall), plan.cluster, plan.rows_per_cta,
            int(plan.resident), plan.groups, plan.smem_bytes,
            ctypes.c_void_p(stream),
        )
    _raise_on("pcg_fixed", lib, err)
    LAUNCHES["pcg_fixed_tall" if tall else "pcg_fixed"] += 1
    return delta


def active_clusters(B: int, H: int, W: int, tall: bool = False) -> int:
    """How many clusters of ``pcg_plan(B, H, W)`` the current CUDA device
    holds at once (cudaOccupancyMaxActiveClusters); 0 means the plan cannot
    run."""
    from .. import _build

    plan = pcg_plan(B, H, W)
    lib = _build.load("pcg")
    n = lib.pcg_active_clusters(
        B, W, plan.cluster, int(plan.resident), plan.groups, plan.smem_bytes,
        int(tall), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if n < 0:
        _raise_on("active_clusters", lib, -n)
    return n


def _pcg_fixed_three_pass(b, pre, s, c, vmasks, fitmask, wf2, wr2,
                          iters: int) -> torch.Tensor:
    """The earlier three-pass form of the kernel (standard layout, 1 +
    3·iters launches a call): the yardstick that ``chip_smoke.py`` times
    beside ``pcg_fixed``. CPU tensors run the plain version. Not counted."""
    if b.device.type == "cpu":
        return pcg_fixed_plain(b, pre, s, c, vmasks, fitmask, wf2, wr2, iters)
    if b.device.type != "cuda":
        raise ValueError(f"_pcg_fixed_three_pass: no kernel for {b.device}")
    from .. import _build

    B, H, W, iters, w = _kernel_operands("_pcg_fixed_three_pass", b, pre, s,
                                         c, vmasks, fitmask, wf2, wr2, iters)
    lib = _build.load("pcg")
    delta, r, p, ap = (torch.empty_like(b) for _ in range(4))
    part = torch.empty((3, B, lib.pcg_three_pass_nblk(H, W)),
                       dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.pcg_three_pass_f32(
            *(_ptr(t) for t in (b, pre, s, c, vmasks, fitmask, w, delta, r,
                                p, ap, part)),
            B, H, W, iters, ctypes.c_void_p(stream),
        )
    _raise_on("_pcg_fixed_three_pass", lib, err)
    return delta
