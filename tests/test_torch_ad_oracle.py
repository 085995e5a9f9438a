"""The port's hand-derived ARAP operators against torch's autodiff and
against the explicit sparse Jacobian (the dumpJ export), as
tests/test_energy.py and tests/test_dumpj.py hold the JAX package's.

Same problems and tolerances as those files: JtF against the gradient of
the cost (2e-5), JtJ·p against vjp(jvp(p)) (3e-5), diag(JtJ) against the
explicit Jacobian from ``torch.func.jacfwd`` (2e-5), exact zeros on the
excluded pixels; J·p, Jᵀr, diag(JᵀJ) and JᵀJ·p from the dense COO Jacobian
(2e-4). The port's ``sparse_jacobian`` equals the JAX package's on the same
state: rows and columns equal, values within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd, jvp, vjp

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu_torch.ops import energy as E

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _np(t):
    return t.detach().numpy()


def _energy_problem(H=13, W=17, seed=0):
    """tests/test_energy.py's problem: an elliptical blob, four random
    constraints and the border pins, a perturbed state, α = 0.7."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = ((yy - H / 2) ** 2 / (H / 3) ** 2
            + (xx - W / 2) ** 2 / (W / 3) ** 2) < 1.0
    arap_mask[blob] = 0
    ys, xs = np.where(arap_mask == 0)
    cons = [[xs[k], ys[k], xs[k] + rng.integers(-3, 4),
             ys[k] + rng.integers(-3, 4)]
            for k in rng.choice(len(ys), size=4, replace=False)]
    cons = add_border_pins(np.array(cons, np.int32).reshape(-1, 4), W, H)
    ops = E.build_operands(arap_mask, cons, device="cpu")
    x = E.init_state(ops) + 0.5 * _t(rng.standard_normal((3, H, W)))
    return ops, x, E.anneal_constraints(ops, 0.7)


def test_jtf_matches_grad():
    ops, x, cimg = _energy_problem()
    jtf, _ = E.jtf_and_diag(x, ops, cimg)
    g = grad(lambda xx: E.cost(xx, ops, cimg))(x)
    np.testing.assert_allclose(_np(jtf), _np(g), rtol=2e-5, atol=2e-5)


def test_apply_jtj_matches_vjp_jvp():
    ops, x, cimg = _energy_problem(seed=1)
    p = _t(np.random.default_rng(3).standard_normal(x.shape))
    s, c = E.trig(x)

    def rfun(xx):
        return E.residuals(xx, ops, cimg)

    _, jp = jvp(rfun, (x,), (p,))
    _, pullback = vjp(rfun, x)
    (oracle,) = pullback(jp)
    np.testing.assert_allclose(_np(E.apply_jtj(p, ops, s, c)), _np(oracle),
                               rtol=3e-5, atol=3e-5)


def test_diag_matches_explicit_jacobian():
    ops, x, cimg = _energy_problem(H=8, W=9, seed=2)
    _, diag = E.jtf_and_diag(x, ops, cimg)
    J = jacfwd(lambda xx: E.residuals(xx, ops, cimg).reshape(-1))(x)
    oracle = (J.reshape(-1, x.numel()) ** 2).sum(0).reshape(x.shape)
    np.testing.assert_allclose(_np(diag), _np(oracle), rtol=2e-5, atol=2e-5)


def test_excluded_pixels_inert():
    ops, x, cimg = _energy_problem(seed=4)
    excluded = _np(ops.mask) == 0
    jtf, _ = E.jtf_and_diag(x, ops, cimg)
    assert np.abs(_np(jtf)[:, excluded]).max() == 0
    p = _t(excluded[None] * np.ones(x.shape))
    s, c = E.trig(x)
    assert np.abs(_np(E.apply_jtj(p, ops, s, c))).max() == 0


def _dumpj_problem(H=12, W=16, seed=0):
    """tests/test_dumpj.py's problem, as (port operands, JAX operands,
    state, constraint image)."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2 : H - 2, 3 : W - 3] = 0
    cons = add_border_pins(np.array([[5, 4, 7, 5], [10, 6, 11, 8]], np.int32),
                           W, H)
    ops = E.build_operands(arap_mask, cons, device="cpu")
    jops = JE.build_operands(arap_mask, cons)
    x = E.init_state(ops) + 0.3 * _t(rng.standard_normal((3, H, W)))
    return ops, jops, x, E.anneal_constraints(ops, 1.0)


def _dense_j(ops, cimg, x):
    H, W = x.shape[-2:]
    rows, cols, vals = E.sparse_jacobian(x, ops, cimg)
    J = np.zeros((10 * H * W, 3 * H * W), np.float64)
    np.add.at(J, (rows, cols), vals)
    return J


@pytest.mark.parametrize("seed", [0, 5])
def test_sparse_jacobian_equals_jax(seed):
    ops, jops, x, cimg = _dumpj_problem(seed=seed)
    got = E.sparse_jacobian(x, ops, cimg)
    want = JE.sparse_jacobian(jnp.asarray(_np(x)), jops, jnp.asarray(_np(cimg)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].dtype == want[2].dtype == np.float32
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)


def test_jp_matches_jvp():
    ops, _, x, cimg = _dumpj_problem()
    J = _dense_j(ops, cimg, x)
    p = _t(np.random.default_rng(1).standard_normal(x.shape))
    _, jp = jvp(lambda xx: E.residuals(xx, ops, cimg), (x,), (p,))
    np.testing.assert_allclose(J @ _np(p).ravel(), _np(jp).ravel(),
                               rtol=2e-4, atol=2e-4)


def test_jtr_matches_vjp_and_jtf():
    ops, _, x, cimg = _dumpj_problem(seed=2)
    J = _dense_j(ops, cimg, x)
    r = _np(E.residuals(x, ops, cimg))
    jtf, diag = E.jtf_and_diag(x, ops, cimg)
    np.testing.assert_allclose((J.T @ r.ravel()).reshape(x.shape), _np(jtf),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.einsum("ij,ij->j", J, J).reshape(x.shape),
                               _np(diag), rtol=2e-4, atol=2e-4)


def test_jtjp_matches_apply_jtj():
    ops, _, x, cimg = _dumpj_problem(seed=3)
    J = _dense_j(ops, cimg, x)
    s, c = E.trig(x)
    p = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    ref = (J.T @ (J @ p.ravel())).reshape(x.shape)
    got = _np(E.apply_jtj(_t(p), ops, s, c))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_structure_masked_rows_absent():
    ops, _, x, cimg = _dumpj_problem(seed=5)
    H, W = x.shape[-2:]
    rows, cols, vals = E.sparse_jacobian(x, ops, cimg)
    assert (vals != 0).all()
    excluded = _np(ops.mask).ravel() == 0
    assert not excluded[cols % (H * W)].any()


def test_sparse_jacobian_batch_is_block_diagonal():
    """A batch of two problems: problem k's entries, offset by k·10·H·W rows
    and k·3·H·W columns."""
    a, _, xa, ca = _dumpj_problem(seed=6)
    b, _, xb, cb = _dumpj_problem(seed=7)
    H, W = xa.shape[-2:]
    batch = E.ArapOperands(**{f: torch.stack([getattr(a, f), getattr(b, f)])
                              for f in vars(a)})
    rows, cols, vals = E.sparse_jacobian(torch.stack([xa, xb]), batch,
                                         torch.stack([ca, cb]))
    ra, ca_, va = E.sparse_jacobian(xa, a, ca)
    rb, cb_, vb = E.sparse_jacobian(xb, b, cb)
    np.testing.assert_array_equal(rows, np.concatenate([ra, rb + 10 * H * W]))
    np.testing.assert_array_equal(cols, np.concatenate([ca_, cb_ + 3 * H * W]))
    np.testing.assert_array_equal(vals, np.concatenate([va, vb]))
