"""Opt C-API facade (compat/opt_api.py of the JAX package).

The reference exposes its solver through a 10-function C API
(ARAP/API/release/include/Opt.h:35-71), driven by OptSolver.h:43-91:
NewState → ProblemDefine → ProblemPlan → [SetSolverParameter] →
ProblemSolve | (ProblemInit; ProblemStep*; ProblemCurrentCost) → PlanFree →
ProblemDelete. Problem parameters arrive as an order-significant list: for
the ARAP plan, slots 0-6 are Offset, Angle, UrShape, Constraints, Mask,
w_fitSqrt, w_regSqrt (arap_plan.t:2-8).

This module runs that lifecycle over the port's solvers, so code written
against the Opt API maps one to one. The "plan file" names the built-in
ARAP energy; numpy arrays stand in for device pointers, and the state's
device (``Opt_NewState(device=...)``, default ``cuda``) holds the operands
and the unknowns between steps. A ``gaussNewtonGPU`` step is one
``solver.gn_step`` (on the card one ``pcg_fixed`` launch of
min(cap, lIterations) iterations); an ``LMGPU`` step is one
``lm.lm_step`` with the trust region kept from step to step. After every
step the cost is read back and the unknowns are written into the caller's
Offset and Angle buffers, as the reference updates its bound images.
Nothing is compiled per parameter value: an lIterations sweep reuses the
loaded kernels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import energy as E
from ..ops import lm as L
from ..ops import solver as S


@dataclass
class OptState:
    device: torch.device
    problems: dict = field(default_factory=dict)
    plans: dict = field(default_factory=dict)


@dataclass
class _Problem:
    name: str


@dataclass
class _Plan:
    problem: _Problem
    dims: tuple
    device: torch.device
    params: dict = field(default_factory=dict)
    solver_params: dict = field(
        # defaults: solverGPUGaussNewton.t:26-39
        default_factory=lambda: {"nIterations": 10, "lIterations": 10}
    )
    # the unknowns (3, H, W) on the host, as the caller's buffers hold them
    state: np.ndarray | None = None
    x: torch.Tensor | None = None  # the same on the state's device
    ops: E.ArapOperands | None = None
    n_iter_done: int = 0
    cost: float = float("nan")
    # LMGPU per-solve state (ssq, radius, decrease factor, cost): ssq is
    # captured once per solve, and the trust region persists across
    # ProblemStep calls (OptSolver.h:72-91)
    lm_state: tuple | None = None


def Opt_NewState(verbosity: int = 0, device="cuda") -> OptState:
    """Opt.h: create the library state on `device`."""
    return OptState(device=torch.device(device))


def Opt_ProblemDefine(state: OptState, plan_path: str,
                      solver_kind: str) -> _Problem:
    """Opt.h: register a problem. `plan_path` names the energy (only the
    built-in ARAP plan exists); solver_kind is 'gaussNewtonGPU' or
    'LMGPU' (CombinedSolverBase.h:74-81)."""
    if solver_kind not in ("gaussNewtonGPU", "LMGPU"):
        raise ValueError(f"unknown solver kind {solver_kind}")
    p = _Problem(name=solver_kind)
    state.problems[id(p)] = p
    return p


def Opt_ProblemPlan(state: OptState, problem: _Problem, dims) -> _Plan:
    """Opt.h: the plan for dims (W, H). The kernels build on first use."""
    plan = _Plan(problem=problem, dims=tuple(int(d) for d in dims),
                 device=state.device)
    state.plans[id(plan)] = plan
    return plan


def Opt_SetSolverParameter(state: OptState, plan: _Plan, name: str,
                           value) -> None:
    plan.solver_params[name] = (
        float(np.asarray(value).ravel()[0]) if np.asarray(value).size
        else value
    )


def _bind(plan: _Plan, problem_params: list) -> None:
    """Order-significant parameter binding (arap_plan.t:2-8); the constraint
    image arrives already annealed by the caller."""
    offset, angle, _urshape, constraints, mask, w_fit_sqrt, w_reg_sqrt = (
        problem_params)
    W, H = plan.dims
    mask = np.asarray(mask, np.float32).reshape(H, W)
    cons_img = np.asarray(constraints, np.float32).reshape(H, W, 2)
    weights = E.ArapWeights(w_fit=float(np.asarray(w_fit_sqrt) ** 2),
                            w_reg=float(np.asarray(w_reg_sqrt) ** 2))
    arap_mask = (mask != 0).astype(np.uint8) * 255
    ops = E.build_operands(arap_mask, np.zeros((0, 4), np.int32), weights,
                           device=plan.device)
    fit = ((cons_img[:, :, 0] >= 0) & (cons_img[:, :, 1] >= 0)).astype(
        np.float32) * (arap_mask == 0)
    cons = torch.as_tensor(np.ascontiguousarray(cons_img.transpose(2, 0, 1)),
                           device=plan.device)
    plan.ops = dataclasses.replace(
        ops, con_src=cons, con_tgt=cons,
        fitmask=torch.as_tensor(fit, device=plan.device))
    x = np.zeros((3, H, W), np.float32)
    x[:2] = np.asarray(offset, np.float32).reshape(H, W, 2).transpose(2, 0, 1)
    x[2] = np.asarray(angle, np.float32).reshape(H, W)
    plan.state = x
    plan.x = torch.as_tensor(x, device=plan.device)


def Opt_ProblemInit(state: OptState, plan: _Plan, problem_params: list) -> None:
    _bind(plan, problem_params)
    plan.n_iter_done = 0
    plan.lm_state = None


def _writeback(plan: _Plan, problem_params: list) -> None:
    """Write the unknowns into the caller's bound Offset/Angle buffers in
    place: in the reference the unknowns ARE the bound device images,
    updated by every step (PCGLinearUpdate, solverGPUGaussNewton.t:1115)."""
    offset, angle = problem_params[0], problem_params[1]
    W, H = plan.dims
    views = []
    for name, buf, shape in (("Offset", offset, (H, W, 2)),
                             ("Angle", angle, (H, W))):
        # A torch tensor is refused as a jax array is in the JAX package.
        # Otherwise np.asarray must give the caller's memory (the ndarray
        # itself, or a view over a buffer-protocol object): a silent copy
        # (a list) would make every step a no-op for the caller. Strided
        # but writable bindings are fine as long as the reshape aliases.
        bad = isinstance(buf, torch.Tensor)
        view = None
        if not bad:
            arr = np.asarray(buf)
            bad = (arr is not buf and arr.base is None) or not arr.flags.writeable
        if not bad:
            view = arr.reshape(shape)
            bad = not np.shares_memory(view, arr)  # the reshape copied
        if bad:
            raise TypeError(
                f"{name} binding must be a writable numpy buffer (got "
                f"{type(buf).__name__}): the Opt API updates the bound "
                "unknowns in place every step (PCGLinearUpdate, "
                "solverGPUGaussNewton.t:1115); bind numpy arrays for "
                "slots 0-1")
        views.append(view)
    views[0][...] = plan.state[:2].transpose(1, 2, 0)
    views[1][...] = plan.state[2]


def _finish_step(plan: _Plan, x: torch.Tensor, cst: torch.Tensor,
                 problem_params: list) -> None:
    plan.x = x
    plan.state = x.cpu().numpy()
    plan.cost = float(cst)
    plan.n_iter_done += 1
    _writeback(plan, problem_params)


def Opt_ProblemStep(state: OptState, plan: _Plan, problem_params: list) -> int:
    """One nonlinear iteration; returns nonzero while iterations remain
    (Opt.h, o.t:2548-2551). 'gaussNewtonGPU' runs one GN iteration with an
    lIterations PCG budget (0 leaves the unknowns unchanged); 'LMGPU' one
    trust-region iteration with a budget of at least 1 (its acceptance
    test needs a trial step)."""
    if plan.state is None:
        _bind(plan, problem_params)
    n = int(plan.solver_params.get("nIterations", 10))
    if plan.n_iter_done >= n:
        return 0
    l_iters = float(plan.solver_params.get("lIterations", 10))
    cap = int(np.ceil(l_iters))
    x, ops = plan.x, plan.ops
    cimg = ops.con_tgt
    if plan.problem.name == "LMGPU":
        cfg = L.LMConfig(pcg_iters=max(cap, 1))
        if plan.lm_state is None:
            _, ssq = E.jtf_and_diag(x, ops, cimg)
            plan.lm_state = (ssq, cfg.init_radius, 2.0, E.cost(x, ops, cimg))
        ssq, radius, dec, prev_cost = plan.lm_state
        x, radius, dec, cst, done = L.lm_step(
            x, ops, cimg, ssq, radius, dec, prev_cost, cfg,
            pcg_budget=max(l_iters, 1.0))
        plan.lm_state = (ssq, radius, dec, cst)
        _finish_step(plan, x, cst, problem_params)
        if bool(done):  # function tolerance or minimum radius
            plan.n_iter_done = n
            return 0
    else:
        cfg = S.SolverConfig(num_anneal=1, gn_iters=1, max_pcg_iters=cap,
                             pcg_iters=l_iters)
        x, _ = S.gn_step(x, ops, cimg, S.resolve_for(ops, cfg), l_iters,
                         0.0, 0.0)
        _finish_step(plan, x, E.cost(x, ops, cimg), problem_params)
    return 1 if plan.n_iter_done < n else 0


def Opt_ProblemSolve(state: OptState, plan: _Plan, problem_params: list) -> None:
    """Init, then step until done (the loop of OptSolver.h:72-91); every
    step writes the unknowns back into the caller's buffers."""
    Opt_ProblemInit(state, plan, problem_params)
    while Opt_ProblemStep(state, plan, problem_params):
        pass


def Opt_ProblemCurrentCost(state: OptState, plan: _Plan) -> float:
    return plan.cost


def Opt_PlanFree(state: OptState, plan: _Plan) -> None:
    state.plans.pop(id(plan), None)


def Opt_ProblemDelete(state: OptState, problem: _Problem) -> None:
    state.problems.pop(id(problem), None)
