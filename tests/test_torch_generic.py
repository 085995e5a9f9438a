"""The port's AD-generic Gauss-Newton (ops/generic.py, ``torch.func``) and
its graph energies (ops/graph.py) against the JAX package's and against the
port's specialised ARAP operators, with the tolerances of
tests/test_generic_lm_compat.py and tests/test_graph.py: cost rtol 1e-6,
the generic GN solve within 1e-4 of the specialised GN steps,
the graph energy within rtol 1e-5 of the stencil's, the graph solve within
5e-3. JtF and JtJ·p are held within rtol/atol 2e-5 and 3e-5,
tests/test_energy.py's tolerances for the same comparisons: the atol-only
2e-5 and 3e-5 of tests/test_generic_lm_compat.py are about one float32 ulp
at the fit terms' values (|JtF| ≈ 180-300), where autograd and the closed
form round 2 ulps apart (observed relative gaps ≤ 2e-7). ``grid_edges`` is array-equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import generic as JG
from arap_flow_tpu.ops import graph as JGR
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import generic as G
from arap_flow_tpu_torch.ops import graph as GR
from arap_flow_tpu_torch.ops import solver as S

torch.set_num_threads(1)


def _problem(H=14, W=18, seed=0):
    """tests/test_generic_lm_compat.py's problem, as (port operands, JAX
    operands)."""
    arap_mask = np.zeros((H, W), np.uint8)
    rng = np.random.default_rng(seed)
    cons = np.array([[4, 5, 6, 7], [11, 4, 12, 6]], np.int32)
    if seed:
        cons = cons.copy()
        cons[:, 2:] += rng.integers(-1, 2, cons[:, 2:].shape)
    cons = add_border_pins(cons, W, H)
    return (E.build_operands(arap_mask, cons, device="cpu"),
            JE.build_operands(arap_mask, cons))


def _gn_steps(ops, cimg, n, iters):
    """The specialised GN: `n` gn_step calls at `iters` PCG iterations."""
    cfg = S.resolve_for(ops, S.SolverConfig(num_anneal=1, gn_iters=n,
                                            max_pcg_iters=iters,
                                            pcg_iters=float(iters)))
    x = E.init_state(ops)
    for _ in range(n):
        x, _ = S.gn_step(x, ops, cimg, cfg, float(iters), 0.0, 0.0)
    return x


def test_generic_gn_matches_specialised():
    ops, _ = _problem()
    cimg = E.anneal_constraints(ops, 1.0)
    xg = G.gn_solve(lambda x: E.residuals(x, ops, cimg), E.init_state(ops),
                    gn_iters=2, pcg_iters=40,
                    diag_fn=lambda x: E.jtf_and_diag(x, ops, cimg)[1])
    np.testing.assert_allclose(xg.numpy(), _gn_steps(ops, cimg, 2, 40).numpy(),
                               rtol=0, atol=1e-4)


def test_generic_cost_jtf_jtjp():
    ops, jops = _problem(seed=1)
    rng = np.random.default_rng(2)
    cimg = E.anneal_constraints(ops, 1.0)
    x = E.init_state(ops) + 0.2 * torch.as_tensor(
        rng.standard_normal((3, *ops.mask.shape)), dtype=torch.float32)
    p = torch.as_tensor(rng.standard_normal(x.shape), dtype=torch.float32)

    def rfun(xx):
        return E.residuals(xx, ops, cimg)

    np.testing.assert_allclose(float(G.cost(rfun, x)),
                               float(E.cost(x, ops, cimg)), rtol=1e-6)
    g = G.jtf(rfun, x)
    np.testing.assert_allclose(g.numpy(), E.jtf_and_diag(x, ops, cimg)[0].numpy(),
                               rtol=2e-5, atol=2e-5)
    s, c = E.trig(x)
    jtjp = G.make_jtj_apply(rfun, x)(p)
    np.testing.assert_allclose(jtjp.numpy(), E.apply_jtj(p, ops, s, c).numpy(),
                               rtol=3e-5, atol=3e-5)
    # the same operators of the JAX package's generic solver (one program)
    jcimg = JE.anneal_constraints(jops, 1.0)

    def jrfun(xx):
        return JE.residuals(xx, jops, jcimg)

    jcost, jg, jjtjp = jax.jit(lambda xx, pp: (
        JG.cost(jrfun, xx), JG.jtf(jrfun, xx), JG.make_jtj_apply(jrfun, xx)(pp)
    ))(jnp.asarray(x.numpy()), jnp.asarray(p.numpy()))
    np.testing.assert_allclose(float(G.cost(rfun, x)), float(jcost), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(jtjp.numpy(), np.asarray(jjtjp), rtol=3e-5,
                               atol=3e-5)


def test_generic_pytree_leaves_in_jax_order():
    """A dict of residuals sums its leaves in sorted key order, as JAX
    flattens a dict; tuples and lists in order, None has no leaf."""
    a, b, c = (torch.full((2,), v) for v in (1.0, 2.0, 3.0))
    assert [float(t[0]) for t in G._leaves({"z": a, "b": (b, None, [c])})] == [
        2.0, 3.0, 1.0]
    # one-element leaves, so only the order across leaves matters: in
    # float32 (1 + 1) + 2^24 = 2^24 + 2, but (2^24 + 1) + 1 = 2^24
    tree = {"c": [4096.0], "a": [1.0], "b": [1.0]}
    got = G.cost(lambda t: t, {k: torch.tensor(v) for k, v in tree.items()})
    want = JG.cost(lambda t: t, {k: jnp.asarray(v, jnp.float32)
                                 for k, v in tree.items()})
    assert float(want) == 0.5 * (2 ** 24 + 2)
    assert float(got) == float(want)


def _graph_setup(H=12, W=15):
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2:10, 3:12] = 0
    cons = np.array([[5, 4, 7, 5], [9, 8, 8, 7]], np.int32)
    return arap_mask, cons


def test_grid_edges_equal_jax():
    arap_mask, _ = _graph_setup()
    rng = np.random.default_rng(9)
    ragged = np.where(rng.uniform(size=(9, 11)) > 0.3, 0, 255).astype(np.uint8)
    for m in (arap_mask, ragged, np.zeros((4, 5), np.uint8)):
        got, want = GR.grid_edges(m), JGR.grid_edges(m)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_graph_residuals_match_stencil_and_jax():
    H, W = 12, 15
    arap_mask, cons = _graph_setup(H, W)
    ops = E.build_operands(arap_mask, cons, device="cpu")
    rng = np.random.default_rng(0)
    x = E.init_state(ops) + 0.3 * torch.as_tensor(
        rng.standard_normal((3, H, W)), dtype=torch.float32)
    cimg = E.anneal_constraints(ops, 1.0)
    reg_energy = float(torch.sum(E.residuals(x, ops, cimg)[:8] ** 2))
    edges = GR.grid_edges(arap_mask)
    r_g = GR.arap_graph_residuals(x.reshape(3, -1), torch.as_tensor(edges),
                                  ops.grid.reshape(2, -1), torch.sqrt(ops.wr2))
    np.testing.assert_allclose(float(torch.sum(r_g ** 2)), reg_energy,
                               rtol=1e-5)
    jx = jnp.asarray(x.numpy()).reshape(3, -1)
    want = JGR.arap_graph_residuals(jx, jnp.asarray(edges),
                                    jnp.asarray(ops.grid.numpy()).reshape(2, -1),
                                    jnp.sqrt(jnp.float32(0.01)))
    np.testing.assert_allclose(r_g.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    verts = np.array([3, 40, 77], np.int32)
    tgts = rng.uniform(0, 10, (3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        GR.fit_graph_residuals(x.reshape(3, -1), torch.as_tensor(verts),
                               torch.as_tensor(tgts), 10.0).numpy(),
        np.asarray(JGR.fit_graph_residuals(jx, jnp.asarray(verts),
                                           jnp.asarray(tgts), 10.0)),
        rtol=0, atol=1e-5)


def test_graph_solve_via_generic_gn():
    """The edge-list energy solved by the generic GN reaches the image
    solver's solution over the solve region."""
    H, W = 12, 15
    arap_mask, cons = _graph_setup(H, W)
    ops = E.build_operands(arap_mask, add_border_pins(cons, W, H),
                           device="cpu")
    cimg = E.anneal_constraints(ops, 1.0)
    edges = torch.as_tensor(GR.grid_edges(arap_mask))
    ur = ops.grid.reshape(2, -1)
    verts = torch.nonzero(ops.fitmask.reshape(-1) > 0)[:, 0]
    tgts = cimg.reshape(2, -1)[:, verts].T

    def residual_fn(x_flat):
        return (GR.arap_graph_residuals(x_flat, edges, ur, torch.sqrt(ops.wr2)),
                GR.fit_graph_residuals(x_flat, verts, tgts,
                                       torch.sqrt(ops.wf2)))

    xg = G.gn_solve(residual_fn, E.init_state(ops).reshape(3, -1),
                    gn_iters=4, pcg_iters=120)
    x_img = _gn_steps(ops, cimg, 4, 120).reshape(3, -1)
    active = ops.mask.reshape(-1) > 0
    d = (xg[:, active] - x_img[:, active]).abs()
    assert float(d.max()) < 5e-3, float(d.max())
