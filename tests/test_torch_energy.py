"""The port's ARAP energy operators agree with the JAX package's on the same
numpy-seeded problems.

Tolerance: 1e-5 relative (atol 1e-5 on values of order 1-100). Both sides
compute in float32 with the same operation order; the residue is float32
rounding of different fused/vectorised evaluation orders (XLA vs torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import stencil as JS
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops import stencil as TS

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(H=24, W=40, seed=0):
    """Mask with a blob and a hole, scattered constraints + border pins."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = ((yy - H / 2) / (H / 3)) ** 2 + ((xx - W / 2) / (W / 3)) ** 2 < 1
    mask = np.where(blob, 0, 255).astype(np.uint8)
    mask[H // 2, W // 2] = 255
    n = 30
    x1, y1 = rng.integers(0, W, n), rng.integers(0, H, n)
    cons = np.stack([x1, y1, x1 + rng.integers(-3, 4, n),
                     y1 + rng.integers(-3, 4, n)], 1).astype(np.int32)
    cons = add_border_pins(cons, W, H)
    jops = JE.build_operands(mask, cons)
    tops = TE.build_operands(mask, cons, device="cpu")
    x = np.asarray(JE.init_state(jops)) + 0.4 * rng.standard_normal(
        (3, H, W)).astype(np.float32)
    cimg = np.array(JE.anneal_constraints(jops, 0.6))
    return mask, cons, jops, tops, x.astype(np.float32), cimg


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("dy,dx", TS.DIRS + ((2, -3), (0, 0)))
def test_shift_equal(dy, dx):
    a = np.random.default_rng(3).standard_normal((2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(_np(TS.shift(torch.as_tensor(a), dy, dx)),
                                  np.asarray(JS.shift(jnp.asarray(a), dy, dx)))


def test_build_operands_equal():
    _, _, jops, tops, _, _ = _problem()
    for k, v in jops._asdict().items():
        np.testing.assert_array_equal(_np(getattr(tops, k)), np.asarray(v), k)


def test_operands_from_numpy_both_kinds():
    mask, cons, jops, _, _, _ = _problem(seed=1)
    full = TE.operands_from_numpy(jops, "cpu")
    assert isinstance(full, TE.ArapOperands)
    np.testing.assert_array_equal(_np(full.vmasks), np.asarray(jops.vmasks))
    comp = TE.operands_from_numpy(JE.build_compact(mask, cons), "cpu")
    assert isinstance(comp, TE.CompactOperands)
    assert isinstance(comp.mask_u8, torch.Tensor)
    with pytest.raises(ValueError):
        TE.operands_from_numpy({"mask": np.zeros((2, 2))}, "cpu")


def test_expand_operands_equal():
    mask, cons, _, _, _, _ = _problem(seed=2)
    jc = JE.build_compact(mask, cons)
    tc = TE.build_compact(mask, cons)
    for f in ("mask_u8", "con_tgt_i16", "wf2", "wr2"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    jx = JE.expand_operands(jc)
    tx = TE.expand_operands(tc.to("cpu"))
    for k, v in jx._asdict().items():
        np.testing.assert_array_equal(_np(getattr(tx, k)), np.asarray(v), k)
    with pytest.raises(TypeError):
        TE.expand_operands(tc)  # numpy leaves: ship them first


def test_expand_operands_batched():
    """A stacked batch expands to the stack of per-problem expansions."""
    items = [TE.build_compact(*_problem(seed=s)[:2]) for s in (3, 4)]
    bx = TE.expand_operands(TE.CompactOperands.stack(items).to("cpu"))
    for k, c in enumerate(items):
        one = TE.expand_operands(c.to("cpu"))
        for f, v in vars(one).items():
            torch.testing.assert_close(getattr(bx, f)[k], v, rtol=0, atol=0)


def test_state_helpers_equal():
    _, _, jops, tops, x, _ = _problem(seed=5)
    np.testing.assert_array_equal(_np(TE.init_state(tops)),
                                  np.asarray(JE.init_state(jops)))
    for a in (0.25, 1.0, np.float32(3) / np.float32(19)):
        np.testing.assert_array_equal(
            _np(TE.anneal_constraints(tops, a)),
            np.asarray(JE.anneal_constraints(jops, jnp.float32(a))))
    s, c = TE.trig(torch.as_tensor(x))
    js, jc = JE.trig(jnp.asarray(x))
    np.testing.assert_allclose(_np(s), np.asarray(js), **TOL)
    np.testing.assert_allclose(_np(c), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(_np(TE.make_grid(3, 4, "cpu")),
                                  np.asarray(JE.make_grid(3, 4)))


@pytest.mark.parametrize("seed", [6, 7])
def test_residuals_and_cost_equal(seed):
    _, _, jops, tops, x, cimg = _problem(seed=seed)
    jr = JE.residuals(jnp.asarray(x), jops, jnp.asarray(cimg))
    tr = TE.residuals(torch.as_tensor(x), tops, torch.as_tensor(cimg))
    np.testing.assert_allclose(_np(tr), np.asarray(jr), **TOL)
    jcost = float(JE.cost(jnp.asarray(x), jops, jnp.asarray(cimg)))
    tcost = float(TE.cost(torch.as_tensor(x), tops, torch.as_tensor(cimg)))
    np.testing.assert_allclose(tcost, jcost, rtol=1e-5)


@pytest.mark.parametrize("seed", [8, 9])
def test_jtf_and_diag_equal(seed):
    _, _, jops, tops, x, cimg = _problem(seed=seed)
    jj, jd = JE.jtf_and_diag(jnp.asarray(x), jops, jnp.asarray(cimg))
    tj, td = TE.jtf_and_diag(torch.as_tensor(x), tops, torch.as_tensor(cimg))
    np.testing.assert_allclose(_np(tj), np.asarray(jj), **TOL)
    np.testing.assert_allclose(_np(td), np.asarray(jd), **TOL)


@pytest.mark.parametrize("seed", [10, 11])
def test_apply_jtj_equal(seed):
    _, _, jops, tops, x, _ = _problem(seed=seed)
    p = np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32)
    s, c = JE.trig(jnp.asarray(x))
    ja = JE.apply_jtj(jnp.asarray(p), jops, s, c)
    ts, tc = TE.trig(torch.as_tensor(x))
    ta = TE.apply_jtj(torch.as_tensor(p), tops, ts, tc)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), **TOL)


def test_batched_operators_match_per_problem():
    """A (B, ...) batch with per-problem weights gives each problem's own
    result (the port's explicit batch dimension for the JAX vmap)."""
    probs = [_problem(seed=s) for s in (12, 13)]
    w = [TE.ArapWeights(100.0, 0.01), TE.ArapWeights(50.0, 0.02)]
    ops = [TE.build_operands(m, c, wk, device="cpu")
           for (m, c, *_), wk in zip(probs, w)]
    bops = TE.ArapOperands(**{f: torch.stack([getattr(o, f) for o in ops])
                              for f in vars(ops[0])})
    x = torch.stack([torch.as_tensor(p[4]) for p in probs])
    cimg = torch.stack([torch.as_tensor(p[5]) for p in probs])
    bj, bd = TE.jtf_and_diag(x, bops, cimg)
    s, c = TE.trig(x)
    bap = TE.apply_jtj(x, bops, s, c)
    bcost = TE.cost(x, bops, cimg)
    for k, o in enumerate(ops):
        j1, d1 = TE.jtf_and_diag(x[k], o, cimg[k])
        torch.testing.assert_close(bj[k], j1)
        torch.testing.assert_close(bd[k], d1)
        torch.testing.assert_close(bap[k], TE.apply_jtj(x[k], o, s[k], c[k]))
        torch.testing.assert_close(bcost[k], TE.cost(x[k], o, cimg[k]))
