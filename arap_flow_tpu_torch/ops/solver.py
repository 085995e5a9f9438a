"""Annealed Gauss-Newton + Jacobi-PCG ARAP solver (ops/solver.py of the JAX
package).

The schedule is the reference's: the constraint image anneals from source to
target over ``num_anneal`` steps (α = (i+1)/num_anneal), each step runs
``gn_iters`` Gauss-Newton linearisations, and each linearisation runs up to
``max_pcg_iters`` Jacobi-PCG iterations.

Backends:

- ``"cuda"``: the fixed-count PCG kernel (``ops.pcg.pcg_fixed``), one call
  per GN step running every iteration on the device, in the tall layout when
  ``ARAP_TALL_KERNEL`` is set. On CUDA tensors a solve's GN steps are
  captured once per shape as a CUDA graph and replayed (``_GraphChain``).
  On CPU tensors the same wrapper runs its plain torch version.
- ``"plain"``: ``pcg_solve`` in torch, with the optional ζ and rz early
  exits.
- ``"auto"``: ``"cuda"`` when the operands are CUDA tensors and both
  tolerances are 0, else ``"plain"``. So the parity schedule always runs the
  kernel on a GPU, and a schedule with a tolerance (``--schedule fast``)
  runs the early-exit plain PCG, as the JAX package runs XLA there.
- ``"fused"`` (opt-in, as in the JAX package): the whole schedule in one
  call of ``ops.fused_solver.anneal_solve_fused`` (one thread-block-cluster
  kernel launch on CUDA tensors, a cluster a problem; its plain version on
  CPU tensors). Only float32
  operands with no tolerance and a uniform PCG budget are eligible
  (``fused_eligible``); the rest resolve as ``"auto"`` does.

The route is taken in ``anneal_solve_stats``, which every solve goes
through: ``solve``, ``solve_stats``, ``solve_batch`` and the callers in
models/arap.py (simple, crop and canvas paths) all honour it.

All functions take a leading batch dimension or none (see ops/energy.py).
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling
from . import graphs
from .energy import (
    ArapOperands,
    anneal_constraints,
    apply_jtj,
    cost,
    init_state,
    jtf_and_diag,
    trig,
)

BACKENDS = ("auto", "plain", "cuda", "fused")


class SolverConfig(NamedTuple):
    """Solver schedule; field names and defaults of the JAX ``SolverConfig``.

    pcg_iters is the PCG budget (≤ max_pcg_iters); q_tolerance enables the ζ
    early exit, rz_tolerance the relative preconditioned-residual exit
    (0 = off). Anneal steps i < anneal_split run pcg_iters_early iterations
    when that is > 0.
    """

    num_anneal: int = 19
    gn_iters: int = 8
    max_pcg_iters: int = 400
    pcg_iters: float = 400.0
    q_tolerance: float = 0.0
    rz_tolerance: float = 0.0
    pcg_iters_early: float = 0.0
    anneal_split: float = 0.0
    backend: str = "auto"  # "auto" | "plain" | "cuda" | "fused"

    def resolve(self, device) -> "SolverConfig":
        """Resolve backend='auto', and 'fused' on a schedule the fused
        kernel does not run, for operands on `device`."""
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.backend == "fused" and fused_eligible(self):
            return self
        if self.backend not in ("auto", "fused"):
            return self
        on_cuda = torch.device(device).type == "cuda"
        no_tols = float(self.q_tolerance) == 0.0 and float(self.rz_tolerance) == 0.0
        return self._replace(backend="cuda" if on_cuda and no_tols else "plain")


def fused_eligible(cfg: SolverConfig, dtype=torch.float32) -> bool:
    """Whether a solve runs the whole-schedule fused kernel: backend='fused'
    (an explicit opt-in), no early-exit tolerance (the kernel runs a fixed
    budget), no non-uniform early/late schedule (the kernel runs one budget
    for every anneal step, which also keeps solve_stats' closed-form count
    exact) and float32 operands. The JAX package's VMEM gate (fits_vmem) has
    no counterpart: what does not fit the cluster kernel's shared memory
    stays in device memory (its streamed plan), so every size runs."""
    return (
        cfg.backend == "fused"
        and float(cfg.q_tolerance) == 0.0 and float(cfg.rz_tolerance) == 0.0
        and not (float(cfg.pcg_iters_early) > 0.0
                 and float(cfg.anneal_split) > 0.0)
        and dtype == torch.float32
    )


def resolve_for(ops: ArapOperands, cfg: SolverConfig) -> SolverConfig:
    """resolve() for the operands' device, plus dtype routing: float64
    operands run the plain backend (the kernels are float32 only)."""
    cfg = cfg.resolve(ops.mask.device)
    if ops.mask.dtype != torch.float32 and cfg.backend != "plain":
        cfg = cfg._replace(backend="plain")
    return cfg


def guarded_invert(diag: torch.Tensor) -> torch.Tensor:
    """CERES-style guarded Jacobi inverse 1/(1+√d)² (1 where d = 0)."""
    return 1.0 / torch.square(1.0 + torch.sqrt(diag))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-problem dot product over the (3, H, W) state."""
    return torch.sum(a * b, dim=(-3, -2, -1))


def _bc(t: torch.Tensor) -> torch.Tensor:
    """A batch-shaped scalar broadcast against (..., 3, H, W) state."""
    return t[..., None, None, None]


def pcg_loop(apply, b, pre, budget: float, q_tolerance: float = 0.0,
             rz_tolerance: float = 0.0, reset_period: int = 0):
    """Preconditioned CG on A δ = b from δ = 0, A given as `apply`, `pre`
    the diagonal preconditioner; at most `budget` iterations. With
    `reset_period` the residual is recomputed from scratch, r = b − A·δ,
    every that many iterations instead of updated.

    Returns (δ, iterations run per problem, loop passes). With a tolerance
    (the Q-based ζ test, the relative rz test) each problem stops on its
    own: its state freezes, as under ``vmap`` of the JAX while loop, and
    the loop reads one flag an iteration back to the host to end when all
    have stopped. Without tolerances it runs the budget with no host reads.
    """
    r = b
    z = pre * r
    p = z
    rz = _dot(r, z)
    rz0 = rz
    delta = torch.zeros_like(b)
    q_tol = torch.tensor(q_tolerance, dtype=rz.dtype, device=rz.device)
    rz_tol = torch.tensor(rz_tolerance, dtype=rz.dtype, device=rz.device)
    use_tols = float(q_tolerance) > 0.0 or float(rz_tolerance) > 0.0
    active = torch.ones_like(rz, dtype=torch.bool)
    iters = torch.zeros_like(rz)
    q_prev = torch.zeros_like(rz)
    i = 0
    while i < budget:
        if i and use_tols and not bool(active.any()):
            break
        ap = apply(p)
        pap = _dot(p, ap)
        alpha = _bc(torch.where(pap > 0.0, rz / pap, 0.0))
        delta_n = delta + alpha * p
        if reset_period and (i + 1) % reset_period == 0:
            r_n = b - apply(delta_n)
        else:
            r_n = r - alpha * ap
        z = pre * r_n
        rz_new = _dot(z, r_n)
        beta = _bc(torch.where(rz > 0.0, rz_new / rz, 0.0))
        p_n = z + beta * p
        if use_tols:
            # Q-based ζ test and the relative rz test, per problem
            q = 0.5 * _dot(delta_n, r_n + b)
            zeta = float(np.float32(i + 1.0)) * (q - q_prev) / torch.where(
                q == 0.0, 1.0, q)
            conv = ((q_tol > 0.0) & (zeta < q_tol)) | (
                (rz_tol > 0.0) & (rz_new < rz_tol * rz_tol * rz0))
            a3 = _bc(active)
            delta = torch.where(a3, delta_n, delta)
            r = torch.where(a3, r_n, r)
            p = torch.where(a3, p_n, p)
            rz = torch.where(active, rz_new, rz)
            q_prev = torch.where(active, q, q_prev)
            iters = iters + active.to(iters.dtype)
            active = active & ~conv
        else:
            delta, r, p, rz = delta_n, r_n, p_n, rz_new
            iters = iters + 1.0
        i += 1
    return delta, iters, i


def pcg_solve(ops: ArapOperands, s, c, jtf, diag, max_iters: int,
              pcg_iters=None, q_tolerance: float = 0.0,
              rz_tolerance: float = 0.0):
    """Solve JtJ δ = −JtF with CERES-guarded Jacobi-preconditioned CG
    (``pcg_loop``) for min(max_iters, pcg_iters) iterations at most.

    Returns (δ (..., 3, H, W), iterations run per problem).
    """
    budget = float(np.minimum(
        np.float32(max_iters),
        np.float32(pcg_iters if pcg_iters is not None else max_iters)))
    delta, iters, _ = pcg_loop(lambda p: apply_jtj(p, ops, s, c), -jtf,
                               guarded_invert(diag), budget, q_tolerance,
                               rz_tolerance)
    return delta, iters


def _batched(ops: ArapOperands) -> ArapOperands:
    return ArapOperands(**{k: v[None] for k, v in vars(ops).items()})


def gn_step(x, ops: ArapOperands, cimg, cfg: SolverConfig, pcg_iters: float,
            q_tol: float, rz_tol: float):
    """One Gauss-Newton iteration: linearise at x, PCG-solve, update.
    `cfg` must be resolved. Returns (x', PCG iterations per problem).

    Stages "gn linearise" (the host's issue of the linearisation: trig,
    JtF and the diagonal, the preconditioner and the reshapes) and "pcg
    launch" (the host side of the PCG call: on the cuda backend the plan
    lookup and the launch; on the plain one the whole torch PCG). They time
    the enqueue; once the device's launch queue is full, an enqueue also
    waits for the device, so on a device-bound run they hold device
    time."""
    delta, iters = _gn_step(x, ops, cimg, cfg, pcg_iters, q_tol, rz_tol,
                            profiling.TIMER.stage)
    if cfg.backend == "cuda":
        iters = torch.full(x.shape[:-3], float(iters), dtype=x.dtype,
                           device=x.device)
    return x + delta, iters


def _gn_step(x, ops: ArapOperands, cimg, cfg: SolverConfig, pcg_iters: float,
             q_tol: float, rz_tol: float, stage, tall: bool | None = None):
    """``gn_step``'s work up to the update: (δ, PCG iterations), its two
    parts timed by `stage`, the PCG kernel in the layout `tall` (None:
    ``tall_kernel_enabled()``). On the cuda backend the iterations are the
    budget, a Python int, so that a captured step launches nothing but the
    step itself."""
    if cfg.backend not in ("cuda", "plain"):
        raise ValueError(f"gn_step needs a resolved backend, got {cfg.backend!r}")
    with stage("gn linearise"):
        s, c = trig(x)
        jtf, diag = jtf_and_diag(x, ops, cimg)
        if cfg.backend == "cuda":
            budget = _budget(cfg, pcg_iters)
            bops = ops if x.dim() == 4 else _batched(ops)
            b = -jtf if x.dim() == 4 else -jtf[None]
            pre = guarded_invert(diag).reshape(b.shape)
            s = s.reshape(b.shape[0], *s.shape[-2:])
            c = c.reshape(b.shape[0], *c.shape[-2:])
    with stage("pcg launch"):
        if cfg.backend == "cuda":
            from .pcg import pcg_fixed

            delta = pcg_fixed(b, pre, s, c, bops.vmasks, bops.fitmask,
                              bops.wf2, bops.wr2, budget,
                              tall).reshape(x.shape)
            iters = budget
        else:
            delta, iters = pcg_solve(ops, s, c, jtf, diag, cfg.max_pcg_iters,
                                     pcg_iters, q_tol, rz_tol)
    return delta, iters


def _budget(cfg: SolverConfig, pcg_iters: float) -> int:
    """The cuda backend's PCG iterations of a GN step."""
    return int(np.minimum(np.float32(cfg.max_pcg_iters),
                          np.float32(pcg_iters)))


class _GnGraph:
    """One GN step captured as a CUDA graph on static buffers: the state
    `x` (the step writes x + δ back into it, so replays chain), the
    constraint image `cimg` and the operand leaves `ops`; and the PCG
    launches (``ops.pcg.LAUNCHES``, ``LAUNCH_SHAPES``, ``PLAN_CALLS``) a
    replay makes."""

    def __init__(self, x, ops: ArapOperands, cimg, cfg: SolverConfig,
                 budget: int, tall: bool):
        from . import pcg

        self.x, self.cimg = torch.empty_like(x), torch.empty_like(cimg)
        self.ops = ArapOperands(**{k: torch.empty_like(v)
                                   for k, v in vars(ops).items()})
        launches = dict(pcg.LAUNCHES)
        shapes, plans = Counter(pcg.LAUNCH_SHAPES), Counter(pcg.PLAN_CALLS)

        def step():
            delta, _ = _gn_step(self.x, self.ops, self.cimg, cfg, budget,
                                0.0, 0.0, contextlib.nullcontext, tall)
            self.x.add_(delta)  # x + δ in place: the same add kernel

        self.graph, _ = graphs.capture(x.device, step)
        # the capture ran nothing: what it counted is each replay's
        self.launches = {k: pcg.LAUNCHES[k] - launches.get(k, 0)
                         for k in pcg.LAUNCHES}
        self.shapes = pcg.LAUNCH_SHAPES - shapes
        self.plans = pcg.PLAN_CALLS - plans
        pcg.LAUNCHES.update(launches)
        for counter, before in ((pcg.LAUNCH_SHAPES, shapes),
                                (pcg.PLAN_CALLS, plans)):
            counter.clear()
            counter.update(before)

    def replay(self) -> None:
        from . import pcg

        self.graph.replay()
        for k, n in self.launches.items():
            pcg.LAUNCHES[k] += n
        pcg.LAUNCH_SHAPES.update(self.shapes)
        pcg.PLAN_CALLS.update(self.plans)


class _GraphChain:
    """The GN steps of one solve on the cuda backend and CUDA tensors. Each
    step runs as ``graphs.engage`` says for its ``key``: the first step of
    a key the thread has not met runs ``gn_step``; the key's second step
    captures it (stage "gn graph capture"); every later step of every
    chain with that key replays it (stage "gn graph replay": the copies
    into the graph's static buffers, the operands once a chain and the
    constraint image once an anneal step, and the replay). The replayed
    launches are the eager step's, in its order, so the states are bitwise
    the eager chain's."""

    def __init__(self, ops: ArapOperands, x):
        self.ops = ops
        # the state's and each operand leaf's layout (x + δ keeps x's)
        self.layout = (graphs.layout(x),
                       tuple(graphs.layout(t) for t in vars(ops).values()))
        self.registry = graphs.registry("gn step")
        self.loaded: dict = {}  # graph -> the cimg in its static buffer
        self.iters = np.float32(0.0)

    def key(self, budget: int, tall: bool) -> tuple:
        """What a captured GN step's launches depend on: the state's and
        the operand leaves' device, dtype, shape and strides, the PCG
        budget and the kernel layout."""
        return self.layout, budget, bool(tall)

    def step(self, x, cimg, cfg: SolverConfig, pcg_iters: float):
        from .pcg import tall_kernel_enabled

        budget = _budget(cfg, pcg_iters)
        # the float32 sum of gn_step's per-step counts
        self.iters = np.float32(self.iters + np.float32(budget))
        tall = tall_kernel_enabled()
        key = self.key(budget, tall)
        how = graphs.engage(self.registry, key)
        if how == "eager":
            return gn_step(x, self.ops, cimg, cfg, pcg_iters, 0.0, 0.0)[0]
        timer = profiling.TIMER
        if how == "capture":
            with timer.stage("gn graph capture"):
                self.registry[key] = _GnGraph(x, self.ops, cimg, cfg,
                                              budget, tall)
        g = self.registry[key]
        with timer.stage("gn graph replay"):
            if g not in self.loaded:
                for k, v in vars(self.ops).items():
                    getattr(g.ops, k).copy_(v)
            if x is not g.x:
                g.x.copy_(x)
            if self.loaded.get(g) is not cimg:
                g.cimg.copy_(cimg)
                self.loaded[g] = cimg
            g.replay()
        return g.x

    def finish(self, x):
        """(x, total PCG iterations per problem) of the chain. A state left
        in a static buffer is cloned out of it, so that the next chain of
        the key cannot overwrite what this one's caller still reads."""
        if any(x is g.x for g in self.loaded):
            x = x.clone()
        return x, torch.full(x.shape[:-3], float(self.iters), dtype=x.dtype,
                             device=x.device)


def anneal_solve_stats(ops: ArapOperands, cfg: SolverConfig):
    """Full annealed solve. Returns (x (..., 3, H, W), total PCG iterations
    per problem)."""
    cfg = resolve_for(ops, cfg)
    if cfg.backend == "fused":
        from .fused_solver import anneal_solve_fused, schedule

        x = anneal_solve_fused(ops, cfg)
        num_anneal, gn_iters, pcg_iters = schedule(cfg)
        return x, torch.full(x.shape[:-3], float(num_anneal * gn_iters
                                                 * pcg_iters),
                             dtype=x.dtype, device=x.device)
    return _per_gn_solve(ops, cfg)


def _per_gn_solve(ops: ArapOperands, cfg: SolverConfig, costs=None):
    """The annealed schedule one GN step at a time (`cfg` resolved, not
    fused): ``gn_step`` each, or on the cuda backend and CUDA tensors a
    ``_GraphChain``'s replays. Returns (x, total PCG iterations per
    problem); with `costs` (a (..., num_anneal · gn_iters) tensor) each GN
    step's energy is written into it on the device."""
    x = init_state(ops)
    chain = (_GraphChain(ops, x) if cfg.backend == "cuda" and x.is_cuda
             else None)
    tot = torch.zeros(x.shape[:-3], dtype=x.dtype, device=x.device)
    for i in range(cfg.num_anneal):
        alpha = np.float32(i + 1.0) / np.float32(cfg.num_anneal)
        cimg = anneal_constraints(ops, alpha)
        early = float(cfg.pcg_iters_early) > 0.0 and float(i) < float(cfg.anneal_split)
        pcg_iters = cfg.pcg_iters_early if early else cfg.pcg_iters
        for j in range(cfg.gn_iters):
            if chain is not None:
                x = chain.step(x, cimg, cfg, pcg_iters)
            else:
                x, it = gn_step(x, ops, cimg, cfg, pcg_iters, cfg.q_tolerance,
                                cfg.rz_tolerance)
                tot = tot + it
            if costs is not None:
                costs[..., i * cfg.gn_iters + j] = cost(x, ops, cimg)
    if chain is not None:
        x, tot = chain.finish(x)
    return x, tot


def anneal_solve(ops: ArapOperands, cfg: SolverConfig) -> torch.Tensor:
    return anneal_solve_stats(ops, cfg)[0]


def flow_from_state(x: torch.Tensor, ops: ArapOperands) -> torch.Tensor:
    """Dense flow (..., 2, H, W) = warped position − grid."""
    return x[..., :2, :, :] - ops.grid


def solve(ops: ArapOperands, cfg: SolverConfig):
    """Full solve; returns (state (..., 3, H, W), flow (..., 2, H, W))."""
    x = anneal_solve(ops, cfg)
    return x, flow_from_state(x, ops)


def solve_stats(ops: ArapOperands, cfg: SolverConfig):
    """Like solve() but also returns the PCG iterations run per problem."""
    x, iters = anneal_solve_stats(ops, cfg)
    return x, flow_from_state(x, ops), iters


def solve_instrumented(ops: ArapOperands, cfg: SolverConfig):
    """Full solve recording the energy after every GN step (the JAX
    ``solve_instrumented``). Returns (x, flow, costs (..., num_anneal ·
    gn_iters)).

    Each GN step is ``gn_step`` on the route ``resolve_for`` picks, so on
    CUDA tensors it is one ``pcg_fixed`` launch; each cost is written into
    a preallocated tensor on the operands' device, with no host read, so x
    is bitwise ``anneal_solve``'s with the same config (the early/late
    budget split included). The ``fused`` backend resolves to the per-GN
    route here, as ``auto`` does: the fused kernel has no cost between its
    GN steps."""
    if cfg.backend == "fused":
        cfg = cfg._replace(backend="auto")
    cfg = resolve_for(ops, cfg)
    costs = torch.zeros((*ops.mask.shape[:-2], cfg.num_anneal * cfg.gn_iters),
                        dtype=ops.mask.dtype, device=ops.mask.device)
    x, _ = _per_gn_solve(ops, cfg, costs)
    return x, flow_from_state(x, ops), costs


def solve_batch(ops: ArapOperands, cfg: SolverConfig):
    """Batched solve over the leading axis of every operand leaf; returns
    (states (B, 3, H, W), flows (B, 2, H, W)).

    One GN chain for the whole batch, as the JAX package's kernel route
    (_solve_batch_kernel_impl): on the "cuda" backend each GN step is one
    ``pcg_fixed`` call over all B problems (tall when ARAP_TALL_KERNEL says
    so), each anneal step runs its early or late budget, and
    ``solve_stats`` counts gn_iters · Σ_steps min(max_pcg_iters, budget)
    per problem. The kernel takes per-problem weights, so a batch with
    non-uniform weights takes the same route and still equals its problems
    solved one at a time (the JAX package's uniform_weights gate has
    nothing to protect), and the TPU kernel's VMEM gate has no counterpart:
    the batch's state lives in device memory."""
    if ops.mask.dim() != 3:
        raise ValueError(f"solve_batch: operands of shape "
                         f"{tuple(ops.mask.shape)}, expected (B, H, W)")
    return solve(ops, cfg)
