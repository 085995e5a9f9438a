"""The port's batched PCG and ``solve_batch`` against the JAX package's
batched and tall Pallas kernels (interpret mode) and its batched kernel
route, and the tall layout switch.

Tolerances (tests/test_pallas_batched.py): one iteration of any layout
within 1e-4 (the same arithmetic, summed in another order); after 40
iterations within 3e-3 of the JAX XLA PCG run in float64 on the same inputs
(see test_plain_matches_jax_batched_kernel for why not of the Pallas
kernel's); whole batched solves within 0.05 px max and 0.005 px median of
the flow (truncated CG drifts with the summation order); a batch with
per-problem weights equal to its problems solved one at a time within 1e-4.
Deep PCG runs are held to convergence as in tests/test_torch_pcg.py: after
160 iterations both residuals ≤ 1e-5·‖b‖ and max |Δδ| < 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu.ops.pallas_pcg import (pcg_pallas_batched,
                                          pcg_pallas_batched_tall,
                                          pcg_pallas_tall)
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops import pcg as TP
from arap_flow_tpu_torch.ops import solver as TS

torch.set_num_threads(1)

CONVERGED_ITERS = 160


def _masks_cons(seed, H=16, W=128):
    """tests/test_pallas_batched.py's problem."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    cons = np.stack(
        [xs.ravel(), ys.ravel(),
         xs.ravel() + rng.integers(-3, 4, xs.size),
         ys.ravel() + rng.integers(-3, 4, xs.size)], 1).astype(np.int32)
    return arap_mask, add_border_pins(cons, W, H)


def _stack_jax(probs):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *probs)


def _stack_port(probs):
    return TE.ArapOperands(**{f: torch.stack([getattr(o, f) for o in probs])
                              for f in vars(probs[0])})


def _linear_problems(seeds, state_seed):
    """B linearised problems: (jax operands, b, pre, s, c, jtf) stacked,
    at a perturbed state, as numpy arrays."""
    probs = [JE.build_operands(*_masks_cons(s)) for s in seeds]
    rng = np.random.default_rng(state_seed)
    out = {k: [] for k in ("jtf", "diag", "s", "c")}
    for o in probs:
        x = JE.init_state(o) + 0.25 * jnp.asarray(
            rng.standard_normal((3, *o.mask.shape)), jnp.float32)
        s, c = JE.trig(x)
        jtf, diag = JE.jtf_and_diag(x, o, JE.anneal_constraints(o, 1.0))
        for k, v in zip(out, (jtf, diag, s, c)):
            out[k].append(v)
    arrs = {k: jnp.stack(v) for k, v in out.items()}
    return probs, arrs


def _port_args(probs, arrs):
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    b = _stack_jax(probs)
    return (-t(arrs["jtf"]), TS.guarded_invert(t(arrs["diag"])), t(arrs["s"]),
            t(arrs["c"]), t(b.vmasks), t(b.fitmask), t(b.wf2), t(b.wr2))


def _jax_args(probs, arrs, iters):
    b = _stack_jax(probs)
    return (-arrs["jtf"], JS.guarded_invert(arrs["diag"]), arrs["s"],
            arrs["c"], b.vmasks, b.fitmask, b.wf2[0], b.wr2[0],
            jnp.int32(iters))


def _assert_converged(out, ref, o, s, c, jtf):
    bound = 1e-5 * float(jnp.linalg.norm(jtf))
    for d in (out, ref):
        r = -jtf - JE.apply_jtj(jnp.asarray(d), o, s, c)
        assert float(jnp.linalg.norm(r)) <= bound
    assert np.abs(np.asarray(out) - np.asarray(ref)).max() < 0.01


def _jax_pcg_f64(probs, arrs, iters):
    """The JAX XLA PCG (solver.pcg_solve) in float64 on the float32 inputs
    of _linear_problems, per problem, stacked."""
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
    with jax.enable_x64(True):
        return np.stack([np.asarray(JS.pcg_solve(
            jax.tree.map(f64, o), f64(arrs["s"][i]), f64(arrs["c"][i]),
            f64(arrs["jtf"][i]), f64(arrs["diag"][i]), iters)[0])
            for i, o in enumerate(probs)])


def test_plain_matches_jax_batched_kernel():
    """One iteration to 1e-4. At 40 iterations the float32 iterates of the
    two packages drift apart (on these problems the port and the Pallas
    kernel differ by 0.046 while the Pallas kernel and the JAX XLA PCG,
    which sum in one order, agree to 3.5e-5; drift_report prints these).
    So 40 iterations are held to the JAX XLA PCG in float64 on the same
    inputs: the port in float64 agrees with it to 1e-6 (6.2e-8 here) and
    the port in float32 is within 3e-3 of it (0.0013 here; the Pallas
    kernel is 0.047 away)."""
    probs, arrs = _linear_problems(range(3), 7)
    args = _port_args(probs, arrs)
    ref1 = pcg_pallas_batched(*_jax_args(probs, arrs, 1), interpret=True)
    np.testing.assert_allclose(TP.pcg_fixed_plain(*args, 1).numpy(),
                               np.asarray(ref1), rtol=1e-4, atol=1e-4)
    exact = _jax_pcg_f64(probs, arrs, 40)
    out64 = TP.pcg_fixed_plain(*(a.double() for a in args), 40).numpy()
    assert np.abs(out64 - exact).max() <= 1e-6
    out = TP.pcg_fixed_plain(*args, 40).numpy()
    assert np.abs(out - exact).max() <= 3e-3
    n = CONVERGED_ITERS
    ref = pcg_pallas_batched(*_jax_args(probs, arrs, n), interpret=True)
    out = TP.pcg_fixed_plain(*args, n).numpy()
    for i, o in enumerate(probs):
        _assert_converged(out[i], ref[i], o, arrs["s"][i], arrs["c"][i],
                          arrs["jtf"][i])


def test_plain_matches_jax_batched_tall_kernel():
    probs, arrs = _linear_problems(range(3), 11)
    args = _port_args(probs, arrs)
    ref1 = pcg_pallas_batched_tall(*_jax_args(probs, arrs, 1),
                                   interpret=True)
    np.testing.assert_allclose(TP.pcg_fixed_plain(*args, 1).numpy(),
                               np.asarray(ref1), rtol=1e-4, atol=1e-4)
    n = CONVERGED_ITERS
    ref = pcg_pallas_batched_tall(*_jax_args(probs, arrs, n), interpret=True)
    out = TP.pcg_fixed_plain(*args, n).numpy()
    for i, o in enumerate(probs):
        _assert_converged(out[i], ref[i], o, arrs["s"][i], arrs["c"][i],
                          arrs["jtf"][i])


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_single_tall_kernel(seed):
    probs, arrs = _linear_problems([seed], 13 + seed)
    args = _port_args(probs, arrs)
    o = probs[0]

    def jax_tall(it):
        return pcg_pallas_tall(
            -arrs["jtf"][0], JS.guarded_invert(arrs["diag"][0]), arrs["s"][0],
            arrs["c"][0], o.vmasks, o.fitmask, o.wf2, o.wr2, jnp.int32(it),
            interpret=True)

    np.testing.assert_allclose(TP.pcg_fixed_plain(*args, 1)[0].numpy(),
                               np.asarray(jax_tall(1)), rtol=1e-4, atol=1e-4)
    n = CONVERGED_ITERS
    _assert_converged(TP.pcg_fixed_plain(*args, n)[0].numpy(), jax_tall(n), o,
                      arrs["s"][0], arrs["c"][0], arrs["jtf"][0])


def _batch(seeds, weights=None):
    mc = [_masks_cons(s) for s in seeds]
    ws = weights or [TE.ArapWeights()] * len(seeds)
    jprobs = [JE.build_operands(m, c, JE.ArapWeights(*w))
              for (m, c), w in zip(mc, ws)]
    tprobs = [TE.build_operands(m, c, w, device="cpu")
              for (m, c), w in zip(mc, ws)]
    return jprobs, tprobs


def test_solve_batch_matches_jax_kernel_route():
    """The JAX batched kernel route with a non-uniform early/late schedule:
    flows within 0.05 px max and 0.005 px median; equal iteration counts."""
    jprobs, tprobs = _batch([0, 1])
    sched = dict(num_anneal=4, gn_iters=1, max_pcg_iters=30, pcg_iters=30.0,
                 pcg_iters_early=8.0, anneal_split=2.0)
    cfg = JS.SolverConfig(backend="pallas", **sched)
    _, jflows, jn = JS._solve_batch_kernel_impl(
        _stack_jax(jprobs), cfg.dynamic, cfg.static_key, interpret=True)
    ops = _stack_port(tprobs)
    tcfg = TS.SolverConfig(backend="cuda", **sched)
    xs, flows = TS.solve_batch(ops, tcfg)
    d = np.abs(flows.numpy() - np.asarray(jflows))
    assert d.max() < 0.05 and np.median(d) < 0.005
    _, flows2, n = TS.solve_stats(ops, tcfg)
    torch.testing.assert_close(flows2, flows, rtol=0, atol=0)
    assert n.tolist() == [float(jn)] * 2 == [2 * 8 + 2 * 30] * 2


@pytest.mark.parametrize("backend", ["cuda", "plain", "fused"])
def test_solve_batch_per_problem_weights(backend):
    """A batch whose problems carry different weights equals its problems
    solved one at a time, on every backend (the CUDA kernel takes
    per-problem weights, so no uniform-weights gate is needed)."""
    weights = [TE.ArapWeights(100.0, 0.01), TE.ArapWeights(4.0, 1.0)]
    _, tprobs = _batch([0, 1], weights)
    cfg = TS.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=30,
                          pcg_iters=30.0, backend=backend)
    _, flows = TS.solve_batch(_stack_port(tprobs), cfg)
    for i, o in enumerate(tprobs):
        _, ref = TS.solve(o, cfg)
        torch.testing.assert_close(flows[i], ref, rtol=1e-4, atol=1e-4)
    assert (flows[0] - flows[1]).abs().max() > 1e-3


def test_solve_batch_needs_a_batch():
    _, tprobs = _batch([0])
    with pytest.raises(ValueError, match="expected"):
        TS.solve_batch(tprobs[0], TS.SolverConfig())


@pytest.mark.parametrize("value,on", [("", False), ("0", False),
                                      ("off", False), ("1", True),
                                      ("yes", True)])
def test_tall_flag_read_at_call_time(monkeypatch, value, on):
    monkeypatch.setenv("ARAP_TALL_KERNEL", value)
    assert TP.tall_kernel_enabled() is on


def test_tall_wrapper_on_cpu_is_plain_and_not_counted(monkeypatch):
    probs, arrs = _linear_problems([2], 17)
    args = _port_args(probs, arrs)
    monkeypatch.setenv("ARAP_TALL_KERNEL", "1")
    before = dict(TP.LAUNCHES)
    plain = TP.pcg_fixed_plain(*args, 9)
    for tall in (None, True, False):
        torch.testing.assert_close(TP.pcg_fixed(*args, 9, tall=tall), plain,
                                   rtol=0, atol=0)
    assert TP.LAUNCHES == before


def drift_report(iters: int = 40) -> None:
    """Prints the 40-iteration drift figures quoted in
    test_plain_matches_jax_batched_kernel: max |Δδ| between the port, the
    Pallas batched kernel and the JAX XLA PCG in float32, and of each (and
    of the port in float64) against the JAX XLA PCG in float64."""
    probs, arrs = _linear_problems(range(3), 7)
    args = _port_args(probs, arrs)
    pallas = np.asarray(pcg_pallas_batched(*_jax_args(probs, arrs, iters),
                                           interpret=True))
    xla = np.stack([np.asarray(JS.pcg_solve(
        o, arrs["s"][i], arrs["c"][i], arrs["jtf"][i], arrs["diag"][i],
        iters)[0]) for i, o in enumerate(probs)])
    port = TP.pcg_fixed_plain(*args, iters).numpy()
    port64 = TP.pcg_fixed_plain(*(a.double() for a in args), iters).numpy()
    exact = _jax_pcg_f64(probs, arrs, iters)

    def gap(a, b):
        return float(np.abs(a - b).max())

    print(f"{iters} iterations, float32: port - pallas {gap(port, pallas):.3g}"
          f", pallas - xla {gap(pallas, xla):.3g}; against the JAX XLA PCG "
          f"in float64: port {gap(port, exact):.3g}, pallas "
          f"{gap(pallas, exact):.3g}, xla {gap(xla, exact):.3g}, port in "
          f"float64 {gap(port64, exact):.3g}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_batch_solve.py
    drift_report()
