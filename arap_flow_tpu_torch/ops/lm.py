"""Levenberg-Marquardt (trust-region) solver: the reference's "LMGPU"
(ops/lm.py of the JAX package, whose docstring cites each step).

Each LM iteration at fixed constraints:

- the damped system (JtJ + CtC) δ = −JtF is PCG-solved, with
  CtC = clamp(diag(JtJ)/radius, min·invS²/radius, max·invS²/radius), where
  invS² = 1/SSq and SSq = diag(JtJ) is captured once per solve at its first
  iteration;
- the preconditioner is 1/(CtC + diag), zeroed on inactive unknowns;
- every ``residual_reset_period`` PCG iterations the residual is recomputed
  from scratch, r = b − (JtJ + CtC)·δ, instead of updated;
- the PCG stops early on the ζ test (``q_tolerance``);
- CERES acceptance: ρ = cost change / model cost change against the
  UNDAMPED linear model ½Σ(F + Jδ)²; accepted → radius /= max(1/3,
  1 − (2ρ − 1)³), capped at ``max_radius``, decrease factor 2; rejected →
  x kept, radius /= decrease factor, decrease factor doubled; the solve
  ends on ``function_tolerance`` (accepted steps only) or
  ``min_radius``.

Every function takes a leading batch dimension or none. In a batch each
problem keeps its own radius, decrease factor and ``done`` flag, and its
state freezes once it is done, as under the JAX package's ``vmap``. The ζ
and ``done`` tests read one flag back to the host an iteration; without a
ζ tolerance the PCG loop reads nothing. This is plain torch, as the JAX
package's LM is plain XLA: no kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .energy import (
    ArapOperands,
    anneal_constraints,
    apply_jtj,
    cost,
    init_state,
    jtf_and_diag,
    trig,
)
from .solver import _bc, _dot, flow_from_state, pcg_loop


# PCG iterations run by _pcg_damped, for reports (a batch's loop passes:
# its longest problem's count). Counted on the host: no device read.
ITERATIONS: dict[str, int] = {"pcg_damped": 0}


class LMConfig(NamedTuple):
    """LM parameters; field names and defaults of the JAX ``LMConfig``."""

    num_anneal: int = 19
    max_outer: int = 8  # nIterations
    pcg_iters: int = 400  # lIterations
    residual_reset_period: int = 10
    q_tolerance: float = 1e-4
    function_tolerance: float = 1e-6
    min_relative_decrease: float = 1e-3
    init_radius: float = 1e4
    min_radius: float = 1e-32
    max_radius: float = 1e16
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32


def _batch_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """`v` (a number or a batch-shaped tensor) as a tensor of `like`'s dtype
    and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _finalize_diagonal(diag, ssq, radius, cfg: LMConfig):
    """The clamped LM diagonal CtC and the damped preconditioner, both
    (..., 3, H, W). Inactive unknowns (diag == 0) get CtC = 0 and pre = 0,
    so they stay inert through the damped solve."""
    radius = _bc(_batch_scalar(radius, diag))
    active = diag > 0.0
    unclamped = diag / radius
    inv_ssq = torch.where(ssq > 0.0, 1.0 / torch.where(ssq > 0.0, ssq, 1.0),
                          0.0)
    mult = inv_ssq / radius
    ctc = torch.minimum(torch.maximum(unclamped, cfg.min_lm_diagonal * mult),
                        cfg.max_lm_diagonal * mult)
    pre = torch.where(active, 1.0 / torch.where(active, ctc + diag, 1.0), 0.0)
    return torch.where(active, ctc, 0.0), pre


def _damped_apply(p, ops: ArapOperands, s, c, ctc):
    """(JtJ + CtC)·p."""
    return apply_jtj(p, ops, s, c) + ctc * p


def _pcg_damped(ops: ArapOperands, s, c, jtf, ctc, pre, cfg: LMConfig,
                budget=None):
    """PCG (``solver.pcg_loop``) on the damped system with the residual
    reset every ``residual_reset_period`` iterations and the ζ exit; runs
    min(cfg.pcg_iters, budget) iterations at most."""
    limit = float(np.float32(cfg.pcg_iters))
    if budget is not None:
        limit = min(limit, float(np.float32(budget)))
    delta, _, passes = pcg_loop(
        lambda p: _damped_apply(p, ops, s, c, ctc), -jtf, pre, limit,
        q_tolerance=cfg.q_tolerance,
        reset_period=cfg.residual_reset_period)
    ITERATIONS["pcg_damped"] += passes
    return delta


def lm_step(x, ops: ArapOperands, cimg, ssq, radius, dec, prev_cost,
            cfg: LMConfig = LMConfig(), pcg_budget=None):
    """One LM (trust-region) iteration at fixed constraints: the
    Opt_ProblemStep granularity of "LMGPU". The caller carries (radius,
    decrease factor, cost) from step to step and captures ssq = diag(JtJ)
    once per solve; `pcg_budget` bounds the PCG below ``cfg.pcg_iters``.
    Returns (x, radius, decrease factor, cost, done), the last four
    batch-shaped."""
    radius, dec, prev_cost = (_batch_scalar(v, x)
                              for v in (radius, dec, prev_cost))
    s, c = trig(x)
    g, diag = jtf_and_diag(x, ops, cimg)
    ctc, pre = _finalize_diagonal(diag, ssq, radius, cfg)
    delta = _pcg_damped(ops, s, c, g, ctc, pre, cfg, budget=pcg_budget)
    # the undamped model: prevCost − ½Σ(F + Jδ)² = −(δ·JtF + ½ δ·JtJδ)
    model_change = -(_dot(delta, g)
                     + 0.5 * _dot(delta, apply_jtj(delta, ops, s, c)))
    x_new = x + delta
    new_cost = cost(x_new, ops, cimg)
    cost_change = prev_cost - new_cost
    rho = cost_change / torch.where(model_change == 0.0, 1.0, model_change)
    accept = (cost_change >= 0.0) & (rho > cfg.min_relative_decrease)
    tmp = 1.0 - (2.0 * rho - 1.0) ** 3
    radius_acc = torch.clamp(radius / torch.clamp(tmp, min=1.0 / 3.0),
                             max=cfg.max_radius)
    radius_new = torch.where(accept, radius_acc, radius / dec)
    dec_new = torch.where(accept, 2.0, 2.0 * dec)
    x_next = torch.where(_bc(accept), x_new, x)
    cost_next = torch.where(accept, new_cost, prev_cost)
    done = ((accept & (cost_change <= prev_cost * cfg.function_tolerance))
            | (radius_new <= cfg.min_radius))
    return x_next, radius_new, dec_new, cost_next, done


def _lm_inner(x0, ops: ArapOperands, cimg, cfg: LMConfig, costs=None,
              base: int = 0):
    """Up to ``max_outer`` LM iterations at fixed constraints (one Opt LM
    solve), SSq captured at x0. With `costs`, the accepted cost after
    iteration j is written to costs[..., base + j]; iterations after every
    problem is done repeat its final cost."""
    _, ssq = jtf_and_diag(x0, ops, cimg)
    x = x0
    prev = cost(x0, ops, cimg)
    radius = torch.full_like(prev, cfg.init_radius)
    dec = torch.full_like(prev, 2.0)
    done = torch.zeros_like(prev, dtype=torch.bool)
    for j in range(cfg.max_outer):
        if j and bool(done.all()):
            if costs is not None:
                costs[..., base + j : base + cfg.max_outer] = prev[..., None]
            break
        x_n, radius_n, dec_n, prev_n, done_n = lm_step(
            x, ops, cimg, ssq, radius, dec, prev, cfg)
        live = ~done
        x = torch.where(_bc(live), x_n, x)
        radius = torch.where(live, radius_n, radius)
        dec = torch.where(live, dec_n, dec)
        prev = torch.where(live, prev_n, prev)
        done = done | done_n
        if costs is not None:
            costs[..., base + j] = prev
    return x


def _alpha(i: int, num_anneal: int):
    return np.float32(i + 1.0) / np.float32(num_anneal)


def lm_solve(ops: ArapOperands, cfg: LMConfig = LMConfig()):
    """The annealed LM solve; returns (x, flow) as ``solver.solve`` does."""
    x = init_state(ops)
    for i in range(cfg.num_anneal):
        x = _lm_inner(x, ops, anneal_constraints(ops, _alpha(i, cfg.num_anneal)),
                      cfg)
    return x, flow_from_state(x, ops)


def lm_solve_instrumented(ops: ArapOperands, cfg: LMConfig = LMConfig()):
    """``lm_solve`` recording the accepted cost after every LM iteration:
    returns (x, flow, costs (..., num_anneal · max_outer)); after an early
    exit the final accepted cost repeats."""
    x = init_state(ops)
    costs = torch.zeros((*x.shape[:-3], cfg.num_anneal * cfg.max_outer),
                        dtype=x.dtype, device=x.device)
    for i in range(cfg.num_anneal):
        x = _lm_inner(x, ops, anneal_constraints(ops, _alpha(i, cfg.num_anneal)),
                      cfg, costs, base=i * cfg.max_outer)
    return x, flow_from_state(x, ops), costs
