"""Fixed-count Jacobi-PCG for the ARAP GN system (ops/pallas_pcg.py of the
JAX package): the kernel of the per-GN solve and of ``solve_batch``.

Four parts:

- ``pcg_fixed_plain``: the plain torch version, batched over B problems with
  per-problem weights, the same math as the TPU kernels ``_pcg_kernel`` and
  ``_pcg_kernel_batched`` (loop-constant planes of
  ``_precompute_const_planes`` + the factored JtJ of ``_jtj_factored``).
- ``kernel_plan``: the launch plan of the CUDA kernel for (B, H, W), pure
  Python given the card's active clusters of each candidate plan and its
  SMs. Where p fits a thread-block cluster of 16 CTAs, a cluster plan
  (``pcg_plan``): the CTAs a problem, the rows each owns, and which planes
  live in shared memory. Else the spread plan (``spread_plan``): one
  problem over the whole card, the batch one problem after another, where
  its state fits the card's shared memory; else the streamed plan.
  ``card_plan`` fills in the counts from the device and caches the plan.
- ``pcg_fixed``: the wrapper. A CPU tensor goes to ``pcg_fixed_plain``; a
  CUDA tensor goes to ``csrc/pcg.cu`` (built on first use by ``_build``),
  one launch a call, or raises. There is no fallback between them. The
  spread plan's launches on one device share the device's handshake words
  (``g_spread_sync``), so they must not overlap: issue them on one stream,
  as the port does (the current stream, and graphs replayed on it), or
  order the streams by events.
- ``LAUNCHES``: launch counts per kernel; the wrapper adds one each time it
  launches the CUDA kernel (one call runs all ``iters`` iterations),
  ``LAUNCH_SHAPES`` the same launches by problem shape (B, H, W), and
  ``PLAN_CALLS`` by plan kind (``PcgPlan.kind``).

The tall layout (``ARAP_TALL_KERNEL``, the TPU's ``pcg_pallas_tall`` and
``pcg_pallas_batched_tall``) is a template flag of the same kernels that
reads p as one stacked (3H, W) plane per problem; ``tall=None`` reads the
variable at call time. It is counted as ``pcg_fixed_tall``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
from typing import Callable, NamedTuple

import torch

from ._checks import check_operand, per_problem, weight_pairs
from .stencil import DIRS, shift

LAUNCHES: dict[str, int] = {"pcg_fixed": 0, "pcg_fixed_tall": 0}
LAUNCH_SHAPES: collections.Counter = collections.Counter()
PLAN_CALLS: collections.Counter = collections.Counter()

# The card the plan is made for (an H100): shared memory one block can use,
# of which the kernel's own static arrays take under 1 KB.
SMEM_PER_BLOCK = 232_448
_STATIC_SMEM = 1024
MAX_CLUSTER = 16
# The spread kernel's CTAs at most
MAX_SPREAD = 256


class PcgPlan(NamedTuple):
    """Launch plan of the PCG kernel. A cluster plan: `cluster` CTAs per
    problem, CTA k owning rows [k·rows_per_cta, (k + 1)·rows_per_cta) ∩
    [0, H); p's band in shared memory when `resident` (else the streamed
    plan: p in device memory), beside the halo rows of p that the
    neighbours push; `groups` of (s and c with halo rows, r, Ap, δ) also in
    shared memory, in that order; `smem_bytes` of dynamic shared memory a
    CTA. The spread plan (`px_per_cta` > 0): one launch of `cluster` CTAs
    over the whole card, CTA k owning the pixels [k·px_per_cta, (k + 1)·
    px_per_cta) ∩ [0, H·W) of each problem in turn, its p, s and c with
    halos, r, Ap and δ in shared memory (`rows_per_cta` 0, `resident`
    True, `groups` 0)."""

    cluster: int
    rows_per_cta: int
    resident: bool
    smem_bytes: int
    groups: int
    px_per_cta: int = 0

    @property
    def kind(self) -> str:
        """"spread", "resident" or "streamed"."""
        if self.px_per_cta:
            return "spread"
        return "resident" if self.resident else "streamed"


GroupBytes = Callable[[int, int], tuple[int, ...]]


def _group_bytes(rows: int, W: int) -> tuple[int, ...]:
    """Shared-memory bytes of each optional group of the PCG kernel, in plan
    order."""
    band = 4 * rows * W
    return 2 * (band + 8 * W), 3 * band, 3 * band, 3 * band


def _plan_with(H: int, W: int, cluster: int, resident: bool,
               group_bytes: GroupBytes = _group_bytes) -> PcgPlan:
    """The plan of `cluster` CTAs a problem. The rows are split evenly (the
    last band may be shorter) and the cluster is trimmed so that no CTA is
    left without rows. The groups (`group_bytes(rows, W)`) then fill the
    shared memory that is left, in order, until the next one does not fit
    (the streamed plan keeps none)."""
    rows = -(-H // cluster)
    cluster = -(-H // rows)
    # the halo rows of p above and below the band, then p's band
    smem = 24 * W + (12 * rows * W if resident else 0)
    groups = 0
    for nbytes in group_bytes(rows, W) if resident else ():
        if smem + nbytes > SMEM_PER_BLOCK - _STATIC_SMEM:
            break
        smem += nbytes
        groups += 1
    return PcgPlan(cluster, rows, resident, smem, groups)


def candidate_plans(H: int, W: int,
                    group_bytes: GroupBytes = _group_bytes) -> list[PcgPlan]:
    """The plans the kernel can run an H×W problem with, by cluster size.
    Resident: every cluster from the smallest whose band of p (3 floats a
    pixel) fits a block's shared memory up to 16, trimmed (so one size may
    stand for several). Where p does not fit 16 CTAs, the streamed plan of
    16 alone."""
    budget = SMEM_PER_BLOCK - _STATIC_SMEM
    fits = [c for c in range(1, MAX_CLUSTER + 1)
            if 24 * W + 12 * -(-H // c) * W <= budget]
    if not fits:
        return [_plan_with(H, W, MAX_CLUSTER, False, group_bytes)]
    plans = {}
    for c in range(fits[0], MAX_CLUSTER + 1):
        plan = _plan_with(H, W, c, True, group_bytes)
        plans[plan.cluster] = plan
    return list(plans.values())


def pcg_plan(B: int, H: int, W: int, active: Callable[[PcgPlan], int],
             group_bytes: GroupBytes = _group_bytes) -> PcgPlan:
    """The cluster kernel's plan for B problems of H×W, given `active`: how
    many clusters of a candidate plan the card holds at once; `group_bytes`
    gives the kernel's shared-memory groups (the fused kernel has its own).

    Among ``candidate_plans(H, W, group_bytes)`` it takes the largest
    cluster of which the card holds all B at once: one wave. Where none
    does, the plan with the fewest waves ⌈B / active⌉, the larger cluster on
    a tie. A plan of which no cluster fits (active 0) is never taken while
    another fits."""
    plans = candidate_plans(H, W, group_bytes)
    if len(plans) == 1:
        return plans[0]
    B = max(B, 1)
    runs = [(plan, n) for plan in plans if (n := active(plan)) > 0]
    if not runs:
        return plans[-1]
    return min(runs, key=lambda pn: (-(-B // pn[1]), -pn[0].cluster))[0]


def _spread_bytes(px: int, W: int) -> int:
    """Shared-memory bytes of a spread CTA of `px` pixels: p (3 planes), s
    and c, each with W pixels of halo on both sides, then r, Ap and δ."""
    return 4 * (5 * (px + 2 * W) + 9 * px)


def spread_plan(H: int, W: int, sms: int) -> PcgPlan | None:
    """The spread plan of an H×W problem on a card of `sms` SMs, one CTA an
    SM: the pixels split as evenly as the most CTAs allow (an even count a
    band, for pixel pairs), none with fewer than W pixels (a band's halos
    then come from its two neighbours alone). None where a band's state
    does not fit a block's shared memory."""
    HW = H * W
    budget = SMEM_PER_BLOCK - _STATIC_SMEM
    for n in range(min(sms, MAX_SPREAD), 1, -1):
        px = -(-HW // n)
        px += px % 2
        ctas = -(-HW // px)
        if _spread_bytes(px, W) > budget:
            return None
        if px >= W and HW - (ctas - 1) * px >= W:
            return PcgPlan(ctas, 0, True, _spread_bytes(px, W), 0, px)
    return None


def kernel_plan(B: int, H: int, W: int, active: Callable[[PcgPlan], int],
                sms: int) -> PcgPlan:
    """The PCG kernel's plan for B problems of H×W on a card of `sms` SMs,
    given `active` (``pcg_plan``'s; for a spread plan 1 where the card
    holds all its CTAs at once, else 0): ``pcg_plan``'s where p fits a
    16-CTA cluster, else the spread plan where it exists and the card holds
    it, else the streamed plan."""
    plan = pcg_plan(B, H, W, active)
    if plan.resident:
        return plan
    spread = spread_plan(H, W, sms)
    return spread if spread is not None and active(spread) > 0 else plan


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


def _raise_on(fn: str, err_string, err: int) -> None:
    """Raise on a kernel library's non-zero return code, with the message
    that library's `err_string` gives for it."""
    if err != 0:
        raise RuntimeError(
            f"{fn}: CUDA error {err}: {err_string(err).decode()}")


def pcg_fixed(b, pre, s, c, vmasks, fitmask, wf2, wr2, iters: int,
              tall: bool | None = None) -> torch.Tensor:
    """δ (B,3,H,W) after `iters` PCG iterations (see ``pcg_fixed_plain`` for
    the arguments). CPU tensors run the plain version; CUDA tensors run the
    kernel in one launch on the current stream, without synchronising, with
    ``card_plan``'s plan, in the tall layout when `tall` (None:
    ``tall_kernel_enabled()``). Two spread-plan calls on one device must
    not run at once (on two streams, or a graph replayed beside a call):
    they share the device's handshake words and would mix their epochs."""
    if b.device.type == "cpu":
        return pcg_fixed_plain(b, pre, s, c, vmasks, fitmask, wf2, wr2, iters)
    if b.device.type != "cuda":
        raise ValueError(f"pcg_fixed: no kernel for device {b.device}")
    from .. import _build

    tall = tall_kernel_enabled() if tall is None else bool(tall)
    B, H, W, iters, w = _kernel_operands("pcg_fixed", b, pre, s, c, vmasks,
                                         fitmask, wf2, wr2, iters)
    plan = card_plan(B, H, W, tall, b.device)
    lib = _build.load("pcg")
    delta = torch.empty_like(b)
    with torch.cuda.device(b.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(b.device).cuda_stream)
        if plan.px_per_cta:
            # each CTA's z at its first and last W pixels, read by its
            # neighbours: two buffers, used in turn
            edge = b.new_empty((2, plan.cluster, 2, 3, W))
            err = lib.pcg_spread_f32(
                *(_ptr(t) for t in (b, pre, s, c, vmasks, fitmask, w, delta,
                                    edge)),
                B, H, W, iters, int(tall), plan.cluster, plan.px_per_cta,
                plan.smem_bytes, stream)
        else:
            # device-memory scratch for the planes the plan keeps off the
            # chip
            r = torch.empty_like(b) if plan.groups < 2 else None
            ap = torch.empty_like(b) if plan.groups < 3 else None
            p = None if plan.resident else torch.empty_like(b)
            err = lib.pcg_fixed_f32(
                *(_ptr(t) for t in (b, pre, s, c, vmasks, fitmask, w, delta,
                                    r, p, ap)),
                B, H, W, iters, int(tall), plan.cluster, plan.rows_per_cta,
                int(plan.resident), plan.groups, plan.smem_bytes, stream)
    _raise_on("pcg_fixed", lib.pcg_error_string, err)
    LAUNCHES["pcg_fixed_tall" if tall else "pcg_fixed"] += 1
    LAUNCH_SHAPES[(B, H, W)] += 1
    PLAN_CALLS[plan.kind] += 1
    return delta


def active_clusters(plan: PcgPlan, B: int, W: int, tall: bool = False,
                    device=None) -> int:
    """How many clusters of `plan` (for B problems of width W) the CUDA
    device holds at once (cudaOccupancyMaxActiveClusters; default: the
    current device); 0 means the plan cannot run. A spread plan runs one
    problem at a time over the whole card: 1 where the device holds all its
    CTAs at once (the occupancy API's blocks an SM times the SMs), else
    0."""
    from .. import _build

    lib = _build.load("pcg")
    with torch.cuda.device(device):
        if plan.px_per_cta:
            n = lib.pcg_spread_ctas(W, plan.smem_bytes, int(tall))
        else:
            stream = torch.cuda.current_stream().cuda_stream
            n = lib.pcg_active_clusters(
                B, W, plan.cluster, int(plan.resident), plan.groups,
                plan.smem_bytes, int(tall), ctypes.c_void_p(stream))
    if n < 0:
        _raise_on("active_clusters", lib.pcg_error_string, -n)
    if plan.px_per_cta:
        return int(n >= plan.cluster)
    return n


@functools.cache
def card_plan(B: int, H: int, W: int, tall: bool, device) -> PcgPlan:
    """``kernel_plan`` on a CUDA device: each candidate plan's active
    clusters queried there, and its SMs, once per (B, H, W, layout,
    device)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return kernel_plan(B, H, W, lambda plan: active_clusters(
        plan, B, W, tall, device), sms)
