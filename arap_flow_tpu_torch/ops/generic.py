"""Gauss-Newton from any residual function (ops/generic.py of the JAX
package): the generality of the Opt DSL, with torch's AD in place of a
kernel generator.

``residual_fn(x)`` maps a pytree of unknowns (a tensor, or a tuple, list or
dict of tensors) to a pytree of residual tensors. The GN operators:

- cost      = ½ Σ r²
- JtF       = vjp(r)(r)                       (``torch.func.vjp``)
- JtJ·p     = vjp(r)(jvp(r)(p))               (``torch.func.jvp`` a product,
                                               the vjp linearised once)
- diag(JtJ) comes from the caller (``diag_fn``), or the preconditioner is
  the identity: the per-residual Σ(∂r/∂x)² has no matrix-free form.

The whole pytree is one problem: a batch of problems is the caller's
residual function over the stacked unknowns, and its PCG steps share one
step size. The specialised ARAP operators (ops/energy.py) stay the fast
route; the tests hold this solver to them on the ARAP energy.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp, vjp
from torch.utils._pytree import tree_map

from .solver import guarded_invert


def _leaves(tree) -> list:
    """The tensors of `tree` in the JAX package's order (a dict's keys
    sorted), so that sums over leaves add in the same order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [] if tree is None else [tree]


def _flat_dot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(_leaves(a), _leaves(b)))


def cost(residual_fn: Callable, x) -> torch.Tensor:
    r = residual_fn(x)
    return 0.5 * _flat_dot(r, r)


def jtf(residual_fn: Callable, x):
    """The gradient JtF by one vjp (the pytree structure of x)."""
    r, pullback = vjp(residual_fn, x)
    (g,) = pullback(r)
    return g


def make_jtj_apply(residual_fn: Callable, x):
    """Matrix-free JtJ·p at the linearisation point x."""
    _, pullback = vjp(residual_fn, x)

    def apply(p):
        _, jp = jvp(residual_fn, (x,), (p,))
        (out,) = pullback(jp)
        return out

    return apply


def pcg(residual_fn: Callable, x, diag, iters: int):
    """Jacobi-PCG for JtJ δ = −JtF with the guarded inverse of `diag` (a
    pytree like x), or the identity when `diag` is None; `iters`
    iterations with no host read."""
    g = jtf(residual_fn, x)
    apply_a = make_jtj_apply(residual_fn, x)
    pre = (tree_map(guarded_invert, diag) if diag is not None
           else tree_map(torch.ones_like, g))
    b = tree_map(torch.neg, g)
    r = b
    z = tree_map(torch.mul, pre, r)
    p = z
    delta = tree_map(torch.zeros_like, g)
    rz = _flat_dot(r, z)
    for _ in range(int(iters)):
        ap = apply_a(p)
        pap = _flat_dot(p, ap)
        alpha = torch.where(pap > 0.0, rz / pap, 0.0)
        delta = tree_map(lambda d, pp: d + alpha * pp, delta, p)
        r = tree_map(lambda rr, aa: rr - alpha * aa, r, ap)
        z = tree_map(torch.mul, pre, r)
        rz_new = _flat_dot(z, r)
        beta = torch.where(rz > 0.0, rz_new / rz, 0.0)
        p = tree_map(lambda zz, pp: zz + beta * pp, z, p)
        rz = rz_new
    return delta


def gn_solve(residual_fn: Callable, x0, gn_iters: int = 8,
             pcg_iters: int = 100, diag_fn: Callable | None = None):
    """Gauss-Newton on any residual function; returns the solution pytree.
    Runs on the device of x0's tensors."""
    x = x0
    for _ in range(gn_iters):
        diag = diag_fn(x) if diag_fn is not None else None
        delta = pcg(residual_fn, x, diag, pcg_iters)
        x = tree_map(torch.add, x, delta)
    return x
