"""The port's whole-schedule fused solve (``backend="fused"``) against the
JAX package's fused Pallas kernel (interpret mode) and its XLA solve, and
the routing that sends a solve to it.

Tolerances are the JAX package's own for its fused kernel
(tests/test_pallas_solver.py:35,39): after a 3×2×60 schedule the median
|Δx| < 1e-3 and the final cost within 5%, since truncated CG amplifies the
rounding of a different summation order at isolated pixels. One iteration
of one GN step is the same arithmetic and is held to 1e-4, three to 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu.ops.pallas_solver import anneal_solve_fused as jax_fused
from arap_flow_tpu_torch.models.arap import ArapDeformer
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops import fused_solver as TF
from arap_flow_tpu_torch.ops import solver as TS
from arap_flow_tpu_torch.utils.config import FrameworkConfig

torch.set_num_threads(1)

SHORT = dict(num_anneal=3, gn_iters=2, max_pcg_iters=60, pcg_iters=60.0)


def _problem(H=16, W=128, seed=0):
    """tests/test_pallas_solver.py's problem: an interior solve region with
    a jittered constraint grid and border pins."""
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    rng = np.random.default_rng(seed)
    cons = np.stack(
        [xs.ravel(), ys.ravel(),
         xs.ravel() + rng.integers(-3, 4, xs.size),
         ys.ravel() + rng.integers(-3, 4, xs.size)], 1).astype(np.int32)
    return arap_mask, add_border_pins(cons, W, H)


def _both(seed=0, dtype=None):
    mask, cons = _problem(seed=seed)
    return (JE.build_operands(mask, cons),
            TE.build_operands(mask, cons, device="cpu", dtype=dtype))


def _cost(x, jops):
    cimg = JE.anneal_constraints(jops, 1.0)
    return float(JE.cost(jnp.asarray(x), jops, cimg))


def _assert_close_solve(x, ref, jops):
    d = np.abs(np.asarray(x) - np.asarray(ref))
    assert np.median(d) < 1e-3, np.median(d)
    c, c_ref = _cost(x, jops), _cost(ref, jops)
    assert abs(c - c_ref) < 0.05 * max(abs(c_ref), 1.0), (c, c_ref)


def _one_gn_step(pcg_iters, seed=0):
    jops, tops = _both(seed=seed)
    sched = dict(num_anneal=1, gn_iters=1, max_pcg_iters=pcg_iters,
                 pcg_iters=float(pcg_iters))
    ref = np.asarray(jax_fused(jops, JS.SolverConfig(**sched),
                               interpret=True))
    x = TF.anneal_solve_fused_plain(TS._batched(tops),
                                    TS.SolverConfig(**sched))[0]
    return np.abs(x.numpy() - ref).max()


def test_plain_matches_jax_fused_one_iteration():
    assert _one_gn_step(1) < 1e-4


def test_plain_matches_jax_fused_three_iterations():
    """β, both rz parities and the later iterations' α. On this problem the
    rounding of another summation order already grows to 2.4e-4 by the
    third iteration (each float32 side is 1.3e-4 or 2.7e-4 from the float64
    iterate), while a stale β or rz moves x by 0.49 or more: held to 1e-3."""
    assert _one_gn_step(3) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_fused_kernel(seed):
    jops, tops = _both(seed=seed)
    ref = jax_fused(jops, JS.SolverConfig(**SHORT), interpret=True)
    x = TF.anneal_solve_fused_plain(TS._batched(tops),
                                    TS.SolverConfig(**SHORT))[0]
    _assert_close_solve(x.numpy(), ref, jops)


def test_plain_matches_jax_xla_solve():
    jops, tops = _both(seed=2)
    ref, _ = JS.solve(jops, JS.SolverConfig(backend="xla", **SHORT))
    x = TF.anneal_solve_fused_plain(TS._batched(tops),
                                    TS.SolverConfig(**SHORT))[0]
    _assert_close_solve(x.numpy(), ref, jops)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of the fused plain version (the CPU side of the
    fused route, where the launch counter does not move)."""
    calls = []
    real = TF.anneal_solve_fused_plain

    def counted(ops, cfg):
        calls.append(tuple(ops.mask.shape))
        return real(ops, cfg)

    monkeypatch.setattr(TF, "anneal_solve_fused_plain", counted)
    return calls


def test_fused_route_on_cpu_runs_plain(plain_calls):
    _, tops = _both(seed=3)
    cfg = TS.SolverConfig(backend="fused", **SHORT)
    before = dict(TF.LAUNCHES)
    x, flow = TS.solve(tops, cfg)
    assert plain_calls == [(1, 16, 128)]
    assert TF.LAUNCHES == before
    ref = TF.anneal_solve_fused_plain(TS._batched(tops), cfg)[0]
    torch.testing.assert_close(x, ref, rtol=0, atol=0)
    torch.testing.assert_close(flow, x[:2] - tops.grid, rtol=0, atol=0)


def test_fused_solve_stats_closed_form_count(plain_calls):
    jops, tops = _both(seed=4)
    cfg = TS.SolverConfig(backend="fused", num_anneal=3, gn_iters=2,
                          max_pcg_iters=50, pcg_iters=80.0)
    x, _, iters = TS.solve_stats(tops, cfg)
    assert float(iters) == 3 * 2 * 50  # the budget row min(max, pcg_iters)
    assert len(plain_calls) == 1
    ref = jax_fused(jops, JS.SolverConfig(num_anneal=3, gn_iters=2,
                                          max_pcg_iters=50, pcg_iters=80.0),
                    interpret=True)
    _assert_close_solve(x.numpy(), ref, jops)


@pytest.mark.parametrize("change,expect", [
    (dict(q_tolerance=1e-4), "plain"),
    (dict(rz_tolerance=0.05), "plain"),
    (dict(pcg_iters_early=20.0, anneal_split=2.0), "plain"),
    (dict(dtype=np.float64), "plain"),
])
def test_ineligible_leaves_fused_route(change, expect, plain_calls):
    """Tolerances, a non-uniform schedule or float64 operands resolve as
    'auto' does (on the CPU: the plain PCG) and never reach the fused
    function."""
    change = dict(change)
    dtype = change.pop("dtype", None)
    _, tops = _both(seed=5, dtype=dtype)
    cfg = TS.SolverConfig(backend="fused", **dict(SHORT, **change))
    assert not TS.fused_eligible(cfg, tops.mask.dtype)
    assert TS.resolve_for(tops, cfg).backend == expect
    x, _, _ = TS.solve_stats(tops, cfg)
    assert plain_calls == []
    auto, _, _ = TS.solve_stats(tops, cfg._replace(backend="auto"))
    torch.testing.assert_close(x, auto, rtol=0, atol=0)


def test_fused_routing_table():
    cfg = TS.SolverConfig(backend="fused")
    assert TS.fused_eligible(cfg)
    assert not TS.fused_eligible(cfg, torch.float64)
    assert cfg.resolve("cpu").backend == "fused"
    assert cfg.resolve("cuda").backend == "fused"
    # a fixed non-uniform schedule on the card takes the per-GN kernel
    fast = cfg._replace(pcg_iters_early=150.0, anneal_split=12.0)
    assert fast.resolve("cuda").backend == "cuda"
    assert fast.resolve("cpu").backend == "plain"
    assert cfg._replace(q_tolerance=1e-4).resolve("cuda").backend == "plain"
    assert not TS.fused_eligible(TS.SolverConfig(backend="cuda"))


def test_env_backend_does_not_take_fused(monkeypatch):
    """ARAP_BACKEND accepts auto | plain | cuda, as before; 'fused' is a
    SolverConfig opt-in only (the JAX env takes no 'fused' either)."""
    monkeypatch.setenv("ARAP_BACKEND", "fused")
    assert FrameworkConfig.from_env().solver.backend == "auto"
    monkeypatch.setenv("ARAP_BACKEND", "cuda")
    assert FrameworkConfig.from_env().solver.backend == "cuda"


def _segment(H=40, W=64):
    rng = np.random.default_rng(9)
    mask = np.full((H, W), 255, np.uint8)
    mask[10:30, 14:46] = 0
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[12:28:4, 16:44:4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 2, ys.ravel() + 1],
                    1).astype(np.int32)
    return rgb, mask, cons


@pytest.mark.parametrize("crop", [False, True])
def test_deformer_fused_simple_and_crop(crop, plain_calls):
    """ArapDeformer with backend='fused' runs the fused function once per
    solve in both modes, and agrees with the per-GN plain route."""
    rgb, mask, cons = _segment()
    sched = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)
    buckets = ((32, 48), (32, 64), (48, 64))
    kw = dict(crop=crop, crop_buckets=buckets, device="cpu")
    fused = ArapDeformer(TS.SolverConfig(backend="fused", **sched),
                         **kw).deform(rgb, mask, cons)
    assert len(plain_calls) == 1
    ref = ArapDeformer(TS.SolverConfig(backend="plain", **sched),
                       **kw).deform(rgb, mask, cons)
    d = np.abs(fused.flow - ref.flow)
    assert d.max() < 0.05 and np.median(d) < 1e-3
    assert fused.flow.shape == (40, 64, 2)
    assert (fused.warped_mask != ref.warped_mask).mean() <= 0.005
