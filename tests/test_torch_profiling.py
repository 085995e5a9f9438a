"""The port's instrumented solves and profiling helpers against the JAX
package's, and ``para_gen --warmup``'s prewarm, on the CPU.

- ``solver.solve_instrumented``: one cost a GN step, within 1e-4 relative
  of JAX's on the same operands at 2×2×160, where both PCGs have converged
  (observed 6.4e-7; truncated at 40 iterations, float32 CG's summation
  order alone moves the costs by 1.4e-3), x bitwise the port's ``solve``
  with the same config (the early/late budget included), and
  ``backend="fused"`` taking the per-GN route;
- ``save_solver_iterations``: the same CSV bytes as JAX's;
- ``profile_solve`` and ``device_trace`` (a Chrome trace written);
- ``prewarm`` at one small bucket, in both modes and with a frame shape;
  ``para_gen --warmup`` writes the same products as without it, and
  ``ARAP_WARMUP_FULL`` selects the whole bucket ladder
  (tests/test_torch_endurance.py holds it to JAX's).
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu.utils import profiling as JP
from arap_flow_tpu_torch.io.image import save_image
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import solver as S
from arap_flow_tpu_torch.pipeline import batch as TB
from arap_flow_tpu_torch.pipeline import para_gen as TP
from arap_flow_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

SHORT = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)


def _problem(H=24, W=32, seed=4):
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[3 : H - 3, 4 : W - 4] = 0
    ys, xs = np.mgrid[5 : H - 5 : 5, 6 : W - 6 : 7]
    cons = np.stack([xs.ravel(), ys.ravel(),
                     xs.ravel() + rng.integers(-3, 4, xs.size),
                     ys.ravel() + rng.integers(-3, 4, xs.size)], 1
                    ).astype(np.int32)
    cons = add_border_pins(cons, W, H)
    return (E.build_operands(arap_mask, cons, device="cpu"),
            JE.build_operands(arap_mask, cons))


def test_solve_instrumented_matches_jax_and_solve():
    ops, jops = _problem()
    cfg = S.SolverConfig(**SHORT)
    x, flow, costs = S.solve_instrumented(ops, cfg)
    assert costs.shape == (4,) and costs.dtype == torch.float32
    conv = dict(SHORT, max_pcg_iters=160, pcg_iters=160.0)
    _, _, jcosts = JS.solve_instrumented(jops, JS.SolverConfig(**conv,
                                                               backend="xla"))
    np.testing.assert_allclose(
        S.solve_instrumented(ops, S.SolverConfig(**conv))[2].numpy(),
        np.asarray(jcosts), rtol=1e-4)
    assert torch.equal(x, S.solve(ops, cfg)[0])
    cimg = E.anneal_constraints(ops, 1.0)
    assert float(costs[-1]) == float(E.cost(x, ops, cimg))
    # the early/late budget and the fused backend: the per-GN route of solve
    split = cfg._replace(pcg_iters_early=10.0, anneal_split=1.0)
    assert torch.equal(S.solve_instrumented(ops, split)[0],
                       S.solve(ops, split)[0])
    fused = S.solve_instrumented(ops, cfg._replace(backend="fused"))
    assert torch.equal(fused[0], x) and torch.equal(fused[2], costs)


def test_solve_instrumented_batch():
    ops, _ = _problem(seed=5)
    o2, _ = _problem(seed=6)
    batch = E.ArapOperands(**{f: torch.stack([getattr(ops, f), getattr(o2, f)])
                              for f in vars(ops)})
    _, flows, costs = S.solve_instrumented(batch, S.SolverConfig(**SHORT))
    assert costs.shape == (2, 4)
    for k, o in enumerate((ops, o2)):
        _, f1, c1 = S.solve_instrumented(o, S.SolverConfig(**SHORT))
        np.testing.assert_allclose(flows[k].numpy(), f1.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(costs[k].numpy(), c1.numpy(), rtol=1e-5)


@pytest.mark.parametrize("with_times", [False, True])
def test_save_solver_iterations_bytes_equal_jax(tmp_path, with_times):
    costs = np.random.default_rng(1).uniform(0, 50, 12).astype(np.float32)
    times = np.linspace(0.5, 6.0, 12) if with_times else None
    a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
    P.save_solver_iterations(a, torch.as_tensor(costs), times, name="LMGPU")
    JP.save_solver_iterations(b, costs, times, name="LMGPU")
    assert a.read_bytes() == b.read_bytes()
    P.save_solver_iterations(a, costs)
    JP.save_solver_iterations(b, costs)
    assert a.read_bytes() == b.read_bytes()


def test_profile_solve_and_device_trace(tmp_path):
    ops, _ = _problem(seed=7)
    cfg = S.SolverConfig(num_anneal=1, gn_iters=2, max_pcg_iters=10,
                         pcg_iters=10.0)
    logdir = str(tmp_path / "trace")
    with P.device_trace(logdir):
        x, flow, costs, wall = P.profile_solve(ops, cfg)
    assert isinstance(costs, np.ndarray) and costs.shape == (2,)
    assert np.isfinite(costs).all() and wall > 0
    assert torch.equal(x, S.solve(ops, cfg)[0])
    (name,) = os.listdir(logdir)
    assert name.endswith(".json") and osp.getsize(osp.join(logdir, name)) > 0
    with open(osp.join(logdir, name)) as f:
        assert json.load(f)["traceEvents"]


def test_prewarm_runs_each_mode_and_the_matcher(capsys):
    cfg = S.SolverConfig(**SHORT)
    for batched in (True, False):
        TP.prewarm(cfg, E.ArapWeights(), buckets=((32, 64),), batched=batched,
                   frame_shape=None if batched else (48, 64),
                   match_downscale=2, device="cpu")
    out = capsys.readouterr().out
    assert out.count("warmup 32x64:") == 2
    assert out.count("warmup matcher 48x64:") == 1
    assert out.count("warmup done in") == 2


H, W = 64, 96


def _tree(root, n_frames=3):
    rng = np.random.default_rng(2)
    tex = np.kron(rng.uniform(60, 255, (H // 8 + 2, W // 8 + 2, 3)),
                  np.ones((8, 8, 1)))[:H, :W].astype(np.uint8)
    bg = (tex[::-1, ::-1] // 3).copy()
    for d in ("orgRGB", "orgMasks"):
        os.makedirs(osp.join(root, d, "seq0"))
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        y0, x0 = 14 + 2 * t, 20 + 3 * t
        ob = (yy >= y0) & (yy < y0 + 28) & (xx >= x0) & (xx < x0 + 34)
        img[ob] = tex[yy[ob] - 2 * t, xx[ob] - 3 * t]
        mask[ob] = 1
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


def _products(out):
    """Every product file's bytes by relative path; the list file holds
    absolute paths and is compared through the returned lines."""
    return {osp.relpath(osp.join(d, f), out): open(osp.join(d, f), "rb").read()
            for d, _, fs in os.walk(out) for f in fs if f != "all_files.list"}


@pytest.mark.parametrize("mode", ["batched", "simple"])
def test_warmup_changes_no_product(tmp_path, monkeypatch, capsys, mode):
    monkeypatch.setattr(TB, "PREWARM_BUCKETS", ((32, 64),))
    inp = str(tmp_path / "in")
    _tree(inp, n_frames=2)
    runs = {}
    for warm in (False, True):
        out = str(tmp_path / f"out{int(warm)}")
        lines = TP.main_pipeline(
            TP.PipelineFlags(input=inp, output=out, seed=0, mode=mode,
                             match_downscale=2, warmup=warm, device="cpu"),
            solver_cfg=S.SolverConfig(**SHORT))
        runs[warm] = ([osp.relpath(p, out) for ln in lines
                       for p in ln.split(" ")], _products(out))
    assert "warmup 32x64:" in capsys.readouterr().out
    assert len(runs[False][0]) == 3 and runs[True] == runs[False]


def test_warmup_takes_frame_shape_from_size(tmp_path, monkeypatch):
    """--warmup warms PREWARM_BUCKETS (buckets None: ARAP_WARMUP_FULL is
    unset) in the run's mode, and the matcher at the frame shape --size
    (w, h) gives."""
    class Warmed(Exception):
        pass

    def fake_prewarm(cfg, weights, **kw):
        raise Warmed(kw)

    monkeypatch.setattr(TP, "prewarm", fake_prewarm)
    monkeypatch.delenv("ARAP_WARMUP_FULL", raising=False)
    inp = str(tmp_path / "in")
    _tree(inp, n_frames=2)
    for mode in ("batched", "simple"):
        with pytest.raises(Warmed) as e:
            TP.main_pipeline(
                TP.PipelineFlags(input=inp, output=str(tmp_path / "o"),
                                 seed=0, mode=mode, warmup=True,
                                 size=(W, H), device="cpu"),
                solver_cfg=S.SolverConfig(**SHORT))
        (kw,) = e.value.args
        assert kw["buckets"] is None
        assert kw["frame_shape"] == (H, W)
        assert kw["batched"] == (mode == "batched")
