"""The port's Opt C-API facade (compat/opt_api.py) against the JAX
package's, with the cases of tests/test_generic_lm_compat.py:88-295.

Both facades drive the same Opt.h lifecycles on the same numpy inputs (a
12×16 grid, one pulled pixel, a pinned border): after every step the
unknowns in the caller's buffers are within 1e-4 of JAX's (observed
≤ 1.5e-5) and the step costs within 1e-4 relative. Also: LMGPU routes to
the trust-region solver (``lm._lm_inner`` reproduced within 1e-5), an
lIterations sweep honours the budget without building or loading any
library, the writeback's rejects (a list, a torch tensor) and accepts (a
strided view), and lIterations = 0 as a no-op of the GN step. The facade
on the card is held to the CPU in tests/test_torch_card_paths.py.
"""

import numpy as np
import pytest
import torch

from arap_flow_tpu import compat as jopt
from arap_flow_tpu_torch import _build
from arap_flow_tpu_torch import compat as opt
from arap_flow_tpu_torch.ops.lm import LMConfig, _lm_inner

torch.set_num_threads(1)

H, W = 12, 16


def _params(H=H, W=W):
    """tests/test_generic_lm_compat.py's bindings: Offset and UrShape the
    grid, Angle 0, pixel (7, 5) pulled to (9, 6), the border pinned, an
    all-solve mask, w_fitSqrt 10, w_regSqrt 0.1."""
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1).copy()
    constraints = np.full((H, W, 2), -1.0, np.float32)
    constraints[5, 7] = (9.0, 6.0)
    for x in range(W):
        constraints[0, x] = (x, 0)
        constraints[H - 1, x] = (x, H - 1)
    for y in range(H):
        constraints[y, 0] = (0, y)
        constraints[y, W - 1] = (W - 1, y)
    return [offset, np.zeros((H, W), np.float32), offset.copy(), constraints,
            np.zeros((H, W), np.float32), np.float32(10.0), np.float32(0.1)]


def _lifecycle(api, kind, n_iter=4, l_iter=60, device=None, params=None):
    """Init, then step until done; returns (params, [(Offset, Angle,
    cost) after each step], plan)."""
    state = api.Opt_NewState() if device is None else api.Opt_NewState(
        device=device)
    prob = api.Opt_ProblemDefine(state, "arap_plan.t", kind)
    plan = api.Opt_ProblemPlan(state, prob, (W, H))
    api.Opt_SetSolverParameter(state, plan, "nIterations", n_iter)
    api.Opt_SetSolverParameter(state, plan, "lIterations", l_iter)
    params = _params() if params is None else params
    api.Opt_ProblemInit(state, plan, params)
    steps = []
    while True:
        more = api.Opt_ProblemStep(state, plan, params)
        steps.append((params[0].copy(), params[1].copy(),
                      api.Opt_ProblemCurrentCost(state, plan)))
        if not more:
            break
    api.Opt_PlanFree(state, plan)
    api.Opt_ProblemDelete(state, prob)
    return params, steps, plan


@pytest.fixture(scope="module")
def jax_runs():
    return {kind: _lifecycle(jopt, kind)[1]
            for kind in ("gaussNewtonGPU", "LMGPU")}


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
def test_lifecycle_matches_jax_facade(jax_runs, kind):
    params, steps, plan = _lifecycle(opt, kind, device="cpu")
    want = jax_runs[kind]
    assert len(steps) == len(want)
    for (off, ang, cost), (joff, jang, jcost) in zip(steps, want):
        np.testing.assert_allclose(off, joff, rtol=0, atol=1e-4)
        np.testing.assert_allclose(ang, jang, rtol=0, atol=1e-4)
        np.testing.assert_allclose(cost, jcost, rtol=1e-4)
    # the unknowns ARE the bound buffers after every step
    np.testing.assert_array_equal(params[0], plan.state[:2].transpose(1, 2, 0))
    np.testing.assert_array_equal(params[1], plan.state[2])
    assert np.isfinite(steps[-1][2])
    moved = params[0][5, 7] - np.array([7.0, 5.0])
    assert moved[0] > 1.0 and moved[1] > 0.4, params[0][5, 7]


def test_lm_routes_to_the_trust_region_solver():
    """'LMGPU' runs LM, not GN: the step costs differ from GN's, and the
    lifecycle reproduces lm._lm_inner on the same operands."""
    _, gn, _ = _lifecycle(opt, "gaussNewtonGPU", device="cpu")
    params, lm, plan = _lifecycle(opt, "LMGPU", device="cpu")
    assert not np.allclose([c for *_, c in gn[: len(lm)]],
                           [c for *_, c in lm])
    p0 = _params()
    ops = plan.ops
    x0 = torch.as_tensor(np.concatenate([p0[0].transpose(2, 0, 1),
                                         p0[1][None]]))
    x_ref = _lm_inner(x0, ops, ops.con_tgt, LMConfig(max_outer=4,
                                                     pcg_iters=60))
    np.testing.assert_allclose(plan.state, x_ref.numpy(), rtol=0, atol=1e-5)


def test_liter_sweep_honours_the_budget_and_loads_no_library(monkeypatch):
    """lIterations sweeps rebuild and reload nothing: every build or load of
    a library raises here, and the budget still takes effect."""
    def refuse(*a, **k):
        raise AssertionError("a library was built or loaded")

    for name in ("build", "load", "build_native", "load_native"):
        monkeypatch.setattr(_build, name, refuse)
    for kind in ("gaussNewtonGPU", "LMGPU"):
        finals = {}
        for l_iter in (50, 70, 4):
            finals[l_iter] = _lifecycle(opt, kind, l_iter=l_iter,
                                        device="cpu")[2].state
        assert not np.allclose(finals[70], finals[4]), kind


@pytest.mark.parametrize("slot, kind", [(0, "list"), (0, "tensor"),
                                        (1, "tensor")])
def test_writeback_rejects_unwritable_bindings(slot, kind):
    params = _params()
    params[slot] = (params[slot].tolist() if kind == "list"
                    else torch.from_numpy(params[slot]))
    name = ("Offset", "Angle")[slot]
    with pytest.raises(TypeError, match=f"{name}.*writable"):
        _lifecycle(opt, "gaussNewtonGPU", n_iter=1, l_iter=5, device="cpu",
                   params=params)
    with pytest.raises(TypeError, match=f"{name}.*writable"):
        _lifecycle(jopt, "gaussNewtonGPU", n_iter=1, l_iter=5,
                   params=_as_jax_binding(slot, kind))


def _as_jax_binding(slot, kind):
    """The JAX facade's counterpart of the bad binding: a list, or a jax
    array where the port is given a torch tensor."""
    import jax.numpy as jnp

    params = _params()
    params[slot] = (params[slot].tolist() if kind == "list"
                    else jnp.asarray(params[slot]))
    return params


def test_writeback_accepts_noncontiguous_view():
    params = _params()
    base = np.zeros((2 * H, W, 2), np.float32)
    view = base[::2]
    assert not view.flags.c_contiguous
    view[...] = params[0]
    params[0] = view
    _, _, plan = _lifecycle(opt, "gaussNewtonGPU", n_iter=1, l_iter=5,
                            device="cpu", params=params)
    np.testing.assert_array_equal(base[::2], plan.state[:2].transpose(1, 2, 0))
    assert not np.allclose(base[::2], 0.0)


def test_zero_literations_is_a_noop_for_gn_only():
    params = _params()
    before = params[0].copy(), params[1].copy()
    _lifecycle(opt, "gaussNewtonGPU", n_iter=2, l_iter=0, device="cpu",
               params=params)
    assert params[0].tobytes() == before[0].tobytes()
    assert params[1].tobytes() == before[1].tobytes()
    # LM takes at least one PCG iteration: its acceptance needs a step
    params = _params()
    _lifecycle(opt, "LMGPU", n_iter=1, l_iter=0, device="cpu", params=params)
    assert not np.array_equal(params[0], before[0])


def test_state_holds_its_device():
    state = opt.Opt_NewState(device="cpu")
    plan = opt.Opt_ProblemPlan(state, opt.Opt_ProblemDefine(
        state, "arap_plan.t", "gaussNewtonGPU"), (W, H))
    opt.Opt_ProblemInit(state, plan, _params())
    assert plan.x.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in vars(plan.ops).values())
    assert opt.Opt_NewState().device == torch.device("cuda")
    with pytest.raises(ValueError):
        opt.Opt_ProblemDefine(state, "arap_plan.t", "conjugateGradient")
