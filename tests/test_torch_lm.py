"""The port's LM (trust-region) solver against the JAX package's
(tests/test_lm.py's problems and checks), on the CPU.

Criteria:
- ``_finalize_diagonal``: CtC and the preconditioner within rtol 1e-6 of
  JAX's, inactive unknowns exactly inert, the clamp engaged at a tiny
  radius;
- ``_pcg_damped`` at 120 iterations with the residual reset every 10 and
  without it: within 1e-4 of JAX's (observed ≤ 6e-6 on |δ| ≈ 4), the two
  within 1e-3 of each other, the reset's true residual no worse than 1.5×;
- ``lm_step`` and the 3×4×100 ``lm_solve`` / ``lm_solve_instrumented`` on
  24×32: flows within 0.05 px, costs within 1e-4 relative, the same accept
  pattern. These run with the ζ exit off (q_tolerance = 0): with it on, the
  first LM step's PCG stops one way or the other on float32 noise in ζ (the
  first cost 3% apart on two of four seeds), and the JAX package's LM
  cannot run in float64 (its while-loop carries are float32). The ζ exit
  itself is held to JAX's accept pattern and to the JAX test's monotone
  costs;
- a batch equals its problems solved one at a time.
"""

import jax.numpy as jnp
import numpy as np
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import lm as JL
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import lm as L
from arap_flow_tpu_torch.ops import solver as S

torch.set_num_threads(1)

NO_ZETA = dict(num_anneal=3, max_outer=4, pcg_iters=100, q_tolerance=0.0)


def _problem(H=24, W=32, seed=0, spread=4):
    """tests/test_lm.py's problem: an interior region, a jittered constraint
    grid and the border pins. Returns (port operands, JAX operands)."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[3 : H - 3, 4 : W - 4] = 0
    ys, xs = np.mgrid[5 : H - 5 : 5, 6 : W - 6 : 7]
    cons = np.stack(
        [xs.ravel(), ys.ravel(),
         xs.ravel() + rng.integers(-spread, spread + 1, xs.size),
         ys.ravel() + rng.integers(-spread, spread + 1, xs.size)], 1
    ).astype(np.int32)
    cons = add_border_pins(cons, W, H)
    return (E.build_operands(arap_mask, cons, device="cpu"),
            JE.build_operands(arap_mask, cons))


def _linearised(seed):
    ops, jops = _problem(seed=seed)
    cimg = E.anneal_constraints(ops, 1.0)
    x = E.init_state(ops)
    s, c = E.trig(x)
    g, diag = E.jtf_and_diag(x, ops, cimg)
    jx = JE.init_state(jops)
    js, jc = JE.trig(jx)
    jg, jdiag = JE.jtf_and_diag(jx, jops, JE.anneal_constraints(jops, 1.0))
    return (ops, s, c, g, diag), (jops, js, jc, jg, jdiag)


def _jcfg(cfg: L.LMConfig) -> JL.LMConfig:
    return JL.LMConfig(**cfg._asdict())


def _accepts(costs, max_outer):
    """Accepted LM iterations after the first of each anneal step: a
    rejected step repeats the previous accepted cost exactly."""
    c = np.asarray(costs).reshape(-1, max_outer)
    return c[:, 1:] != c[:, :-1]


def test_finalize_diagonal_matches_jax_and_clamps():
    (_, _, _, _, diag), (_, _, _, _, jdiag) = _linearised(0)
    cfg = L.LMConfig()
    ctc, pre = L._finalize_diagonal(diag, diag, 1e4, cfg)
    jctc, jpre = JL._finalize_diagonal(jdiag, jdiag, jnp.float32(1e4),
                                       _jcfg(cfg))
    np.testing.assert_allclose(ctc.numpy(), np.asarray(jctc), rtol=1e-6)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=1e-6)
    d, c, p = diag.numpy(), ctc.numpy(), pre.numpy()
    active = d > 0
    assert (c[~active] == 0).all() and (p[~active] == 0).all()
    np.testing.assert_allclose(c[active], d[active] / 1e4, rtol=1e-6)
    np.testing.assert_allclose(p[active], 1.0 / (c[active] + d[active]),
                               rtol=1e-6)
    tiny = np.float32(1e-40)
    c2 = L._finalize_diagonal(diag, diag, float(tiny), cfg)[0].numpy()
    maxval = cfg.max_lm_diagonal * (1.0 / d[active]) / float(tiny)
    assert (c2[active] <= maxval * (1 + 1e-5)).all()
    j2 = JL._finalize_diagonal(jdiag, jdiag, jnp.float32(tiny), _jcfg(cfg))[0]
    np.testing.assert_allclose(c2, np.asarray(j2), rtol=1e-6)


def test_pcg_damped_with_and_without_reset_matches_jax():
    (ops, s, c, g, diag), (jops, js, jc, jg, jdiag) = _linearised(3)
    cfg = L.LMConfig(pcg_iters=120, q_tolerance=0.0)
    ctc, pre = L._finalize_diagonal(diag, diag, 1e4, cfg)
    jctc, jpre = JL._finalize_diagonal(jdiag, jdiag, jnp.float32(1e4),
                                       _jcfg(cfg))
    deltas = []
    for period in (10, 10 ** 9):
        k = cfg._replace(residual_reset_period=period)
        d = L._pcg_damped(ops, s, c, g, ctc, pre, k)
        want = JL._pcg_damped(jops, js, jc, jg, jctc, jpre, _jcfg(k))
        np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
        deltas.append(d)
    d_reset, d_none = deltas
    assert float((d_reset - d_none).abs().max()) < 1e-3

    def true_res(delta):
        return float(torch.linalg.vector_norm(
            -g - L._damped_apply(delta, ops, s, c, ctc)))

    assert true_res(d_reset) <= true_res(d_none) * 1.5


def test_pcg_damped_budget_caps_iterations():
    (ops, s, c, g, diag), _ = _linearised(1)
    cfg = L.LMConfig(pcg_iters=120, q_tolerance=0.0)
    ctc, pre = L._finalize_diagonal(diag, diag, 1e4, cfg)
    short = L._pcg_damped(ops, s, c, g, ctc, pre, cfg, budget=7.0)
    same = L._pcg_damped(ops, s, c, g, ctc, pre, cfg._replace(pcg_iters=7))
    assert torch.equal(short, same)


def test_lm_step_matches_jax():
    ops, jops = _problem(seed=7)
    cfg = L.LMConfig(pcg_iters=100, q_tolerance=0.0)
    cimg = E.anneal_constraints(ops, 1.0)
    jcimg = JE.anneal_constraints(jops, 1.0)
    x = E.init_state(ops)
    jx = JE.init_state(jops)
    _, ssq = E.jtf_and_diag(x, ops, cimg)
    _, jssq = JE.jtf_and_diag(jx, jops, jcimg)
    got = L.lm_step(x, ops, cimg, ssq, 1e4, 2.0, E.cost(x, ops, cimg), cfg)
    want = JL.lm_step(jx, jops, jcimg, jssq, jnp.float32(1e4),
                      jnp.float32(2.0), JE.cost(jx, jops, jcimg), _jcfg(cfg))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    for k in (1, 2, 3):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)
    assert bool(got[4]) == bool(want[4])
    assert float(got[2]) == 2.0  # accepted


def test_lm_solve_and_instrumented_match_jax():
    ops, jops = _problem(seed=3)
    cfg = L.LMConfig(**NO_ZETA)
    x, flow, costs = L.lm_solve_instrumented(ops, cfg)
    _, jflow, jcosts = JL.lm_solve_instrumented(jops, _jcfg(cfg))
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-4)
    np.testing.assert_array_equal(_accepts(costs, cfg.max_outer),
                                  _accepts(jcosts, cfg.max_outer))
    # lm_solve runs the same iterations without recording them
    x2, flow2 = L.lm_solve(ops, cfg)
    assert torch.equal(x2, x) and torch.equal(flow2, flow)


def test_lm_zeta_exit_accepts_like_jax_and_costs_monotone():
    """The default ζ exit (q_tolerance 1e-4): the same accepted iterations
    as JAX, the accepted cost non-increasing within each anneal step, and
    the LM flow near GN's on the same energy (tests/test_lm.py's gates)."""
    ops, jops = _problem(seed=1, spread=3)
    cfg = L.LMConfig(num_anneal=3, max_outer=4, pcg_iters=100)
    x, flow, costs = L.lm_solve_instrumented(ops, cfg)
    _, _, jcosts = JL.lm_solve_instrumented(jops, _jcfg(cfg))
    np.testing.assert_array_equal(_accepts(costs, cfg.max_outer),
                                  _accepts(jcosts, cfg.max_outer))
    steps = costs.numpy().reshape(cfg.num_anneal, cfg.max_outer)
    for row in steps:
        assert (np.diff(row) <= 1e-4 * np.abs(row[:-1]) + 1e-6).all(), row
    gn = S.SolverConfig(num_anneal=3, gn_iters=4, max_pcg_iters=100,
                        pcg_iters=100.0)
    gx, gflow = S.solve(ops, gn)
    d = (flow - gflow).abs().numpy()
    assert np.median(d) < 0.05 and d.max() < 1.0
    cimg = E.anneal_constraints(ops, 1.0)
    assert float(E.cost(x, ops, cimg)) <= float(E.cost(gx, ops, cimg)) * 1.05 + 1e-6


def test_lm_batch_equals_problems_one_at_a_time():
    """Each problem of a batch keeps its own trust region and done flag:
    the batch's flows and costs equal the single solves'."""
    probs = [_problem(seed=s)[0] for s in (3, 7, 11)]
    batch = E.ArapOperands(**{f: torch.stack([getattr(o, f) for o in probs])
                              for f in vars(probs[0])})
    cfg = L.LMConfig(num_anneal=2, max_outer=4, pcg_iters=60)
    _, flows, costs = L.lm_solve_instrumented(batch, cfg)
    for k, o in enumerate(probs):
        _, f1, c1 = L.lm_solve_instrumented(o, cfg)
        np.testing.assert_allclose(flows[k].numpy(), f1.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(costs[k].numpy(), c1.numpy(), rtol=1e-6)


def test_lm_solve_finite_and_lowers_the_cost():
    ops, _ = _problem(seed=7)
    x, flow = L.lm_solve(ops, L.LMConfig(num_anneal=3, max_outer=4,
                                         pcg_iters=100))
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(flow).all())
    cimg = E.anneal_constraints(ops, 1.0)
    assert float(E.cost(x, ops, cimg)) < float(E.cost(E.init_state(ops), ops,
                                                      cimg))
