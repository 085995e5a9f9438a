"""The port's annealed GN/PCG solver agrees with the JAX package's at a short
schedule (2 anneal × 2 GN × 40 PCG, the dry-run schedule).

Tolerance: flow within 0.05 px (tests/test_pallas_pcg.py:59, the full-solve
bound the JAX package holds its own kernel to); both sides run float32 with
different summation orders, and 160 PCG iterations amplify the rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops import pcg as TP
from arap_flow_tpu_torch.ops import solver as TS

torch.set_num_threads(1)

SHORT = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)
FLOW_TOL = 0.05


def _problem(H=24, W=48, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ell = ((yy - H / 2) / (H / 3)) ** 2 + ((xx - W / 2) / (W / 3)) ** 2 < 1
    mask = np.where(ell, 0, 255).astype(np.uint8)
    ys, xs = np.mgrid[2:H:3, 2:W:3]
    sel = ell[2:H:3, 2:W:3]
    th = 0.15
    cx, cy = W / 2, H / 2
    xr = np.cos(th) * (xs - cx) - np.sin(th) * (ys - cy) + cx + 2
    yr = np.sin(th) * (xs - cx) + np.cos(th) * (ys - cy) + cy - 1
    cons = np.stack([xs[sel], ys[sel], np.round(xr[sel]), np.round(yr[sel])],
                    1).astype(np.int32)
    cons = add_border_pins(cons[rng.permutation(len(cons))], W, H)
    return mask, cons


def _jax_flow(mask, cons, **cfg):
    _, flow = JS.solve(JE.build_operands(mask, cons), JS.SolverConfig(**cfg))
    return np.asarray(flow)


@pytest.mark.parametrize("seed", [0, 1])
def test_anneal_solve_matches_jax_xla(seed):
    mask, cons = _problem(seed=seed)
    ref = _jax_flow(mask, cons, backend="xla", **SHORT)
    ops = TE.build_operands(mask, cons, device="cpu")
    x = TS.anneal_solve(ops, TS.SolverConfig(backend="plain", **SHORT))
    flow = TS.flow_from_state(x, ops).numpy()
    assert np.abs(flow - ref).max() < FLOW_TOL
    _, flow2 = TS.solve(ops, TS.SolverConfig(**SHORT))  # auto -> plain on CPU
    np.testing.assert_array_equal(flow2.numpy(), flow)


def test_kernel_backend_on_cpu_matches_jax_pallas():
    """backend='cuda' on CPU tensors runs the wrapper's plain version: the
    fixed-count path, held against the JAX Pallas backend (interpret)."""
    mask, cons = _problem(seed=2)
    ref = _jax_flow(mask, cons, backend="pallas", **SHORT)
    ops = TE.build_operands(mask, cons, device="cpu")
    before = dict(TP.LAUNCHES)
    _, flow, iters = TS.solve_stats(ops, TS.SolverConfig(backend="cuda", **SHORT))
    assert np.abs(flow.numpy() - ref).max() < FLOW_TOL
    assert float(iters) == 2 * 2 * 40
    assert TP.LAUNCHES == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("q_tol,rz_tol", [(1e-3, 0.0), (1e-4, 0.0),
                                          (0.0, 0.05), (1e-4, 0.2)])
def test_tolerance_iteration_counts_match_jax(q_tol, rz_tol):
    """With an early exit on, both PCGs stop after the same number of
    iterations on the same linearisation. (Over a whole schedule the ζ test
    amplifies float32 drift between the two, so counts are compared per GN
    step and whole solves on their flow.)"""
    mask, cons = _problem(seed=3)
    jops = JE.build_operands(mask, cons)
    tops = TE.build_operands(mask, cons, device="cpu")
    x = JE.init_state(jops) + 0.2 * jnp.asarray(
        np.random.default_rng(3).standard_normal((3, 24, 48)), jnp.float32)
    for alpha in (0.5, 1.0):
        cimg = JE.anneal_constraints(jops, alpha)
        s, c = JE.trig(x)
        jtf, diag = JE.jtf_and_diag(x, jops, cimg)
        jd, jit = JS.pcg_solve(jops, s, c, jtf, diag, 40, 40.0, q_tol, rz_tol)
        t = [torch.tensor(np.asarray(a)) for a in (s, c, jtf, diag)]
        td, tit = TS.pcg_solve(tops, *t, 40, 40.0, q_tol, rz_tol)
        assert float(tit) == float(jit) < 40
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-3,
                                   atol=1e-3)


def test_fast_schedule_solve_matches_jax():
    """The ζ tolerance of --schedule fast (1e-4) over a whole solve."""
    mask, cons = _problem(seed=3)
    cfg = dict(SHORT, q_tolerance=1e-4)
    _, jflow = JS.solve(JE.build_operands(mask, cons),
                        JS.SolverConfig(backend="xla", **cfg))
    _, flow = TS.solve(TE.build_operands(mask, cons, device="cpu"),
                       TS.SolverConfig(**cfg))
    assert np.abs(flow.numpy() - np.asarray(jflow)).max() < FLOW_TOL


def test_pcg_solve_batch_stops_each_problem_on_its_own():
    """A batch with early exits equals its problems solved one at a time
    (the JAX package's vmap of the while loop)."""
    probs = [_problem(seed=s) for s in (4, 5)]
    ops = [TE.build_operands(m, c, device="cpu") for m, c in probs]
    bops = TE.ArapOperands(**{f: torch.stack([getattr(o, f) for o in ops])
                              for f in vars(ops[0])})
    x = TE.init_state(bops) + 0.2 * torch.as_tensor(
        np.random.default_rng(6).standard_normal((2, 3, 24, 48)),
        dtype=torch.float32)
    cimg = TE.anneal_constraints(bops, 1.0)
    s, c = TE.trig(x)
    jtf, diag = TE.jtf_and_diag(x, bops, cimg)
    d, it = TS.pcg_solve(bops, s, c, jtf, diag, 60, rz_tolerance=0.05)
    for k, o in enumerate(ops):
        d1, it1 = TS.pcg_solve(o, s[k], c[k], jtf[k], diag[k], 60,
                               rz_tolerance=0.05)
        assert float(it[k]) == float(it1)
        torch.testing.assert_close(d[k], d1, rtol=1e-4, atol=1e-5)
    assert float(it[0]) != float(it[1]) or float(it[0]) < 60


def test_non_uniform_schedule_matches_jax():
    mask, cons = _problem(seed=7)
    cfg = dict(num_anneal=3, gn_iters=1, max_pcg_iters=40, pcg_iters=40.0,
               pcg_iters_early=12.0, anneal_split=2.0)
    jops = JE.build_operands(mask, cons)
    _, jflow, jit = JS.solve_stats(jops, JS.SolverConfig(backend="xla", **cfg))
    ops = TE.build_operands(mask, cons, device="cpu")
    _, flow, it = TS.solve_stats(ops, TS.SolverConfig(**cfg))
    assert float(it) == float(jit) == 12 + 12 + 40
    assert np.abs(flow.numpy() - np.asarray(jflow)).max() < FLOW_TOL


def test_guarded_invert_equal():
    d = np.abs(np.random.default_rng(8).standard_normal((3, 5, 6))).astype(
        np.float32) * 10
    d[0, 0, 0] = 0.0
    np.testing.assert_allclose(TS.guarded_invert(torch.as_tensor(d)).numpy(),
                               np.asarray(JS.guarded_invert(jnp.asarray(d))),
                               rtol=1e-6)


def test_backend_routing():
    """auto -> cuda only for CUDA operands with both tolerances 0."""
    cfg = TS.SolverConfig()
    assert cfg.resolve("cpu").backend == "plain"
    assert cfg.resolve("cuda").backend == "cuda"
    assert cfg.resolve(torch.device("cuda", 0)).backend == "cuda"
    assert TS.SolverConfig(q_tolerance=1e-4).resolve("cuda").backend == "plain"
    assert TS.SolverConfig(rz_tolerance=0.1).resolve("cuda").backend == "plain"
    assert TS.SolverConfig(backend="cuda").resolve("cpu").backend == "cuda"
    with pytest.raises(ValueError):
        TS.SolverConfig(backend="pallas").resolve("cpu")
    mask, cons = _problem()
    ops64 = TE.build_operands(mask, cons, device="cpu", dtype=np.float64)
    assert TS.resolve_for(ops64, TS.SolverConfig(backend="cuda")).backend == "plain"
    ops32 = TE.build_operands(mask, cons, device="cpu")
    assert TS.resolve_for(ops32, TS.SolverConfig(backend="cuda")).backend == "cuda"


def test_float64_solve_runs_plain():
    mask, cons = _problem(seed=9)
    ops = TE.build_operands(mask, cons, device="cpu", dtype=np.float64)
    x, flow = TS.solve(ops, TS.SolverConfig(backend="cuda", **SHORT))
    assert x.dtype == torch.float64
    ref = _jax_flow(mask, cons, backend="xla", **SHORT)
    assert np.abs(flow.numpy() - ref).max() < FLOW_TOL
