"""The port's PCG (plain version and wrapper) agrees with the JAX package's
XLA PCG and its Pallas kernel (interpret mode) on the same problems.

One iteration is held to rtol/atol 1e-4, the tolerance of
tests/test_pallas_pcg.py: the math is the same and only the order of
summation differs.

Many iterations are held to convergence, not to a ratio of residuals. After
80 CG iterations on the 16×128 problem the residual norm of each of the
three implementations wanders by several times with the summation order
(‖b‖ ≈ 1140–1235):

    seed  iters  JAX XLA pcg_solve  JAX Pallas (interpret)  pcg_fixed_plain
    2     80     0.0286             0.0039                  0.0097
    3     80     0.0022             0.0056                  0.0121
    0/2/3 160    0.00044/88/34      0.00048/35/39           0.00058/36/46

so "within 2× of the reference at 80 iterations" fails by chance (the JAX
package's own two solvers break it). At 160 iterations every solver has
converged: both residuals ‖b − JtJ·δ‖ must be ≤ 1e-5·‖b‖ (observed
≤ 7.3e-7·‖b‖, a 13× margin) and max |Δδ| < 0.01 (observed ≤ 4e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu.ops.pallas_pcg import pcg_solve_pallas
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops import pcg as TP
from arap_flow_tpu_torch.ops.solver import guarded_invert

torch.set_num_threads(1)


def _problem(H=16, W=128, seed=0):
    """tests/test_pallas_pcg.py's problem: an interior solve region with a
    constraint grid, linearised at a perturbed state."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 2, ys.ravel() - 1],
                    1).astype(np.int32)
    ops = JE.build_operands(arap_mask, add_border_pins(cons, W, H))
    x = JE.init_state(ops) + 0.3 * jnp.asarray(
        rng.standard_normal((3, H, W)), jnp.float32)
    cimg = JE.anneal_constraints(ops, 1.0)
    s, c = JE.trig(x)
    jtf, diag = JE.jtf_and_diag(x, ops, cimg)
    return ops, s, c, jtf, diag


def _port_args(ops, s, c, jtf, diag):
    """The same problem as (B=1) port tensors for pcg_fixed[_plain]."""
    tops = TE.operands_from_numpy(ops, "cpu")
    t = lambda a: torch.tensor(np.asarray(a))[None]  # noqa: E731
    return tops, (-t(jtf), guarded_invert(t(diag)), t(s), t(c),
                  tops.vmasks[None], tops.fitmask[None], tops.wf2, tops.wr2)


def _resnorm(delta, ops, s, c, jtf):
    r = -jtf - JE.apply_jtj(jnp.asarray(delta), ops, s, c)
    return float(jnp.linalg.norm(r))


CONVERGED_ITERS = 160


def _assert_converged(out, ref, ops, s, c, jtf):
    """Both solves converged (residual ≤ 1e-5·‖b‖) to the same δ (< 0.01)."""
    bound = 1e-5 * float(jnp.linalg.norm(jtf))
    assert _resnorm(out, ops, s, c, jtf) <= bound
    assert _resnorm(ref, ops, s, c, jtf) <= bound
    assert np.abs(out - np.asarray(ref)).max() < 0.01


@pytest.mark.parametrize("seed", [0, 2])
def test_plain_matches_xla_pcg(seed):
    ops, s, c, jtf, diag = _problem(seed=seed)
    _, args = _port_args(ops, s, c, jtf, diag)
    ref1, _ = JS.pcg_solve(ops, s, c, jtf, diag, 1)
    out1 = TP.pcg_fixed_plain(*args, 1)[0]
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), rtol=1e-4,
                               atol=1e-4)
    ref, _ = JS.pcg_solve(ops, s, c, jtf, diag, CONVERGED_ITERS)
    out = TP.pcg_fixed_plain(*args, CONVERGED_ITERS)[0].numpy()
    _assert_converged(out, ref, ops, s, c, jtf)


def test_plain_matches_pallas_kernel_interpret():
    ops, s, c, jtf, diag = _problem(seed=3)
    _, args = _port_args(ops, s, c, jtf, diag)
    ref1, _ = pcg_solve_pallas(ops, s, c, jtf, diag, 1, interpret=True)
    np.testing.assert_allclose(TP.pcg_fixed_plain(*args, 1)[0].numpy(),
                               np.asarray(ref1), rtol=1e-4, atol=1e-4)
    ref, _ = pcg_solve_pallas(ops, s, c, jtf, diag, CONVERGED_ITERS,
                              interpret=True)
    out = TP.pcg_fixed_plain(*args, CONVERGED_ITERS)[0].numpy()
    _assert_converged(out, ref, ops, s, c, jtf)


def test_plain_border_poison_inert():
    """Garbage in the excluded pixels' trig planes cannot leak into the
    solve region (the TPU kernel's wrap-around test, for the zero-padded
    neighbour reads of the port)."""
    ops, s, c, jtf, diag = _problem(seed=1)
    _, args = _port_args(ops, s, c, jtf, diag)
    out1 = TP.pcg_fixed_plain(*args, 25)
    excluded = torch.as_tensor(np.asarray(ops.mask) == 0)
    s2 = torch.where(excluded, 77.7, args[2])
    c2 = torch.where(excluded, -55.5, args[3])
    out2 = TP.pcg_fixed_plain(args[0], args[1], s2, c2, *args[4:], 25)
    active = ~excluded
    np.testing.assert_allclose(out1[0][:, active].numpy(),
                               out2[0][:, active].numpy(), rtol=1e-4, atol=1e-4)


def test_plain_batch_with_per_problem_weights():
    """Problems in one batch keep their own (wf2, wr2): batch == singles."""
    probs = [_port_args(*_problem(seed=s))[1] for s in (4, 5)]
    wf2 = torch.tensor([100.0, 30.0])
    wr2 = torch.tensor([0.01, 0.05])
    batch = [torch.cat([p[k] for p in probs]) for k in range(6)]
    out = TP.pcg_fixed_plain(*batch, wf2, wr2, 30)
    for k, p in enumerate(probs):
        one = TP.pcg_fixed_plain(*p[:6], wf2[k], wr2[k], 30)
        torch.testing.assert_close(out[k], one[0], rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_plain_and_not_counted():
    ops, s, c, jtf, diag = _problem(seed=6)
    _, args = _port_args(ops, s, c, jtf, diag)
    before = dict(TP.LAUNCHES)
    torch.testing.assert_close(TP.pcg_fixed(*args, 7),
                               TP.pcg_fixed_plain(*args, 7), rtol=0, atol=0)
    assert TP.LAUNCHES == before
    zero = TP.pcg_fixed(*args, 0)
    assert torch.count_nonzero(zero) == 0


def test_wrapper_refuses_other_devices():
    ops, s, c, jtf, diag = _problem(seed=7)
    _, args = _port_args(ops, s, c, jtf, diag)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        TP.pcg_fixed(*meta, 3)
