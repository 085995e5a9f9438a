"""The port's solve paths on the card, on bench.py's 854x480 deform pair
(two elliptical segments, 19x8x400): the crop path per GN step and with
the fused kernel, the host rasterizer, the Opt C-API facade (both solver
kinds, against the CPU), the generality path, ``solve_instrumented``, the
mesh runner, the row-split solve, the pyramid, the host-raster deform list
and ``run_tasks``; and, on a host of two or more cards, the mesh paths
across them. Every test needs the card and skips without it.
"""

import os

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch import compat as opt
from arap_flow_tpu_torch.io.constraints import add_border_pins
from arap_flow_tpu_torch.io.flo import flow_read, flow_write
from arap_flow_tpu_torch.io.image import save_image
from arap_flow_tpu_torch.models.arap import ArapDeformer
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import solver as S
from arap_flow_tpu_torch.ops.pcg import card_plan
from arap_flow_tpu_torch.parallel import make_mesh, solve_spatial
from arap_flow_tpu_torch.pipeline import para_gen
from arap_flow_tpu_torch.pipeline.batch import BatchRunner, run_tasks
from torch_card import card  # noqa: F401
from torch_card import (FRAME_H, FRAME_W, SEG_SEEDS, SEG_SHAPES,
                        cut_config, make_pipeline_tree, make_tasks,
                        read_bytes, read_counts, rigid_epe_median, run_pair,
                        segment_problem, solve_calls, tree_digest,
                        zero_counts)


@pytest.fixture(scope="module")
def pair(card):
    """The pair's segments and their crop-path tasks."""
    return make_tasks()


@pytest.fixture(scope="module")
def pair_run(card, pair):
    """The pair's run through BatchRunner at 19x8x400 per GN step: its
    products and the launches it made."""
    zero_counts()
    out = run_pair(*pair, S.SolverConfig(), card)
    return out, read_counts()


def _same_products(got, ref) -> bool:
    return sorted(got) == sorted(ref) and all(
        np.array_equal(got[k].flow, ref[k].flow)
        and np.array_equal(got[k].warped_rgb, ref[k].warped_rgb)
        and np.array_equal(got[k].warped_mask, ref[k].warped_mask)
        for k in ref)


@pytest.mark.cuda
def test_deform_pair(card, pair, pair_run, tmp_path):
    """One pcg_fixed launch a solve chunk and GN step, no other kernel; each
    flow survives a .flo round trip, is finite, has a median rigid EPE
    < 1 px, and warps a non-empty mask."""
    probs, tasks = pair
    out, launches = pair_run
    cfg = S.SolverConfig()
    expect = len(solve_calls(tasks)) * cfg.num_anneal * cfg.gn_iters
    assert (launches["pcg_fixed"], launches["pcg_fixed_tall"],
            launches["anneal_solve_fused"]) == (expect, 0, 0)
    for j, (rgb, mask, cons, motion) in enumerate(probs):
        res = out[(0, j)]
        path = str(tmp_path / f"seg{j}.flo")
        flow_write(path, res.flow)
        flow = np.dstack(flow_read(path))
        assert np.array_equal(flow, res.flow)
        assert flow.shape == (FRAME_H, FRAME_W, 2) and np.isfinite(flow).all()
        assert rigid_epe_median(flow, mask, SEG_SHAPES[j][0], motion) < 1.0
        assert (res.warped_mask == 255).sum() > 0


@pytest.mark.cuda
def test_small_crop_problem_matches_cpu(card):
    """A small crop-path problem on the card (kernel) against the same
    problem on the CPU (plain torch): flows within 0.05 px, warped masks
    disagreeing on at most 0.5% of pixels."""
    rng = np.random.default_rng(5)
    H, W = 56, 72
    mask = np.full((H, W), 255, np.uint8)
    mask[18:38, 20:44] = 0
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[20:36:4, 22:42:4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 3, ys.ravel() + 2],
                    1).astype(np.int32)
    buckets = ((32, 32), (32, 48), (48, 48), (48, 64))
    gpu, cpu = (ArapDeformer(cut_config(), crop=True, crop_buckets=buckets,
                             device=d).deform(rgb, mask, cons)
                for d in (card, "cpu"))
    assert float(np.abs(gpu.flow - cpu.flow).max()) < 0.05
    assert float((gpu.warped_mask != cpu.warped_mask).mean()) <= 0.005


@pytest.mark.cuda
def test_fused_deform_pair(card, pair, pair_run):
    """The pair with backend="fused": one fused launch a solve chunk and no
    PCG launch; median rigid EPE < 1 px and median |flow − the per-GN
    flow| < 0.05 px over each segment."""
    probs, tasks = pair
    zero_counts()
    out = run_pair(probs, tasks, S.SolverConfig(backend="fused"), card)
    launches = read_counts()
    assert (launches["anneal_solve_fused"], launches["pcg_fixed"],
            launches["pcg_fixed_tall"]) == (len(solve_calls(tasks)), 0, 0)
    for j, (rgb, mask, cons, motion) in enumerate(probs):
        flow = out[(0, j)].flow
        assert flow.shape == (FRAME_H, FRAME_W, 2) and np.isfinite(flow).all()
        assert rigid_epe_median(flow, mask, SEG_SHAPES[j][0], motion) < 1.0
        d = np.abs(flow - pair_run[0][(0, j)].flow)[mask == 0]
        assert float(np.median(d)) < 0.05


@pytest.mark.cuda
def test_host_raster_deformer(card, pair, pair_run):
    """ArapDeformer(raster="host") on the pair: the native C++ splat
    bitwise equal to its numpy plain version and to the deformer's
    products; a non-empty mask, median rigid EPE < 1 px, and the flow
    within 0.01 px (median) of the device rasterizer's run."""
    from arap_flow_tpu_torch.native.host_raster import (rasterize_warp_exact,
                                                        warp_from_flow)
    from arap_flow_tpu_torch.native.runtime import rasterize_warp

    deformer = ArapDeformer(S.SolverConfig(), crop=True, raster="host",
                            device=card)
    for j, (rgb, mask, cons, motion) in enumerate(pair[0]):
        res = deformer.deform(rgb, mask, cons)
        warp = warp_from_flow(res.flow)
        c_rgb, c_mask = rasterize_warp(warp, rgb, mask)
        p_rgb, p_mask = rasterize_warp_exact(warp, rgb, mask)
        for a, b in ((c_rgb, p_rgb), (c_mask, p_mask),
                     (res.warped_rgb, c_rgb), (res.warped_mask, c_mask)):
            assert np.array_equal(a, b)
        assert (c_mask > 0).sum() > 0
        assert rigid_epe_median(res.flow, mask, SEG_SHAPES[j][0], motion) < 1
        d = np.abs(res.flow - pair_run[0][(0, j)].flow)[mask == 0]
        assert float(np.median(d)) < 0.01


# The Opt C-API facade and the generality path on the pair's frame: segment
# 0's ellipse translated by OPT_T (no rotation), a constraint every 8 px of
# the object and the border pins, in the Opt layout.
OPT_T = (10.0, 8.0)
OPT_SCHEDULE = (19, 8, 400)  # outer (annealing) × nIterations × lIterations
# LM's outer count, cut from the reference's 19: the plain-torch LM reads a
# flag back every damped-PCG iteration, so the host issues each iteration's
# ≈ 100 launches with the queue drained (3.4 ms an iteration, 24.1 s at 19
# outer on the H100).
LM_OUTER = 4
# every outer iteration's final cost is below this fraction of its starting
# cost (the exact solution's cost is 0)
OPT_DROP = 1e-2


def _opt_frame_problem():
    """(arap mask, constraint sources (K, 2), targets (K, 2)) of the Opt
    object: segment 0's ellipse moved by OPT_T, the border pins
    appended."""
    _, arap_mask, _, _ = segment_problem(SEG_SEEDS[0], *SEG_SHAPES[0])
    ell = arap_mask == 0
    ys, xs = np.mgrid[0:FRAME_H:8, 0:FRAME_W:8]
    sel = ell[::8, ::8]
    sx, sy = xs[sel], ys[sel]
    tx, ty = sx + int(OPT_T[0]), sy + int(OPT_T[1])
    keep = (tx >= 0) & (tx < FRAME_W) & (ty >= 0) & (ty < FRAME_H)
    cons = add_border_pins(np.stack([sx, sy, tx, ty], 1)[keep].astype(
        np.int32), FRAME_W, FRAME_H)
    return (arap_mask, cons[:, :2].astype(np.float32),
            cons[:, 2:].astype(np.float32))


def _opt_grid_problem():
    """tests/test_generic_lm_compat.py's problem: a 12x16 grid, all of it
    solved, pixel (7, 5) pulled to (9, 6), the border pinned."""
    H, W = 12, 16
    border = [(x, y) for y in range(H) for x in range(W)
              if y in (0, H - 1) or x in (0, W - 1)]
    src = np.array([(7, 5)] + border, np.float32)
    tgt = np.array([(9, 6)] + border, np.float32)
    return np.zeros((H, W), np.uint8), src, tgt


def _opt_lifecycle(kind: str, schedule, device, problem):
    """The Opt.h lifecycle of examples/opt_api_lifecycle.py on `problem`:
    Offset and UrShape the grid, Angle 0, the constraint image annealed per
    outer iteration (α = (i + 1) / outer), Mask 0 on the object, w_fitSqrt
    10, w_regSqrt √0.01; each outer iteration an Init and Steps until done.
    Returns (Offset, the costs of each outer iteration's steps, each
    preceded by its starting cost, LM's accepts per step)."""
    arap_mask, src, tgt = problem
    n_outer, n_iter, l_iter = schedule
    H, W = arap_mask.shape
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1)
    angle = np.zeros((H, W), np.float32)
    urshape = offset.copy()
    mask = (arap_mask != 0).astype(np.float32)
    sxi, syi = src[:, 0].astype(np.int64), src[:, 1].astype(np.int64)
    state = opt.Opt_NewState(device=device)
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", kind)
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", n_iter)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", l_iter)
    costs, accepts = [], []
    for i in range(n_outer):
        alpha = np.float32(i + 1) / np.float32(n_outer)
        cons = np.full((H, W, 2), -1.0, np.float32)
        cons[syi, sxi] = src + alpha * (tgt - src)
        params = [offset, angle, urshape, cons, mask, np.float32(10.0),
                  np.float32(np.sqrt(0.01))]
        opt.Opt_ProblemInit(state, plan, params)
        # the starting cost, which the Opt API does not report before a step
        row, acc = [float(E.cost(plan.x, plan.ops, plan.ops.con_tgt))], []
        while True:
            more = opt.Opt_ProblemStep(state, plan, params)
            row.append(opt.Opt_ProblemCurrentCost(state, plan))
            if kind == "LMGPU":
                acc.append(float(plan.lm_state[2]) == 2.0)
            if not more:
                break
        costs.append(row)
        accepts.append(acc)
    opt.Opt_PlanFree(state, plan)
    opt.Opt_ProblemDelete(state, prob)
    return offset, costs, accepts


def _object_error(offset, arap_mask) -> float:
    """Median |flow − OPT_T| over the object, flow = Offset − grid."""
    H, W = arap_mask.shape
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    obj = arap_mask == 0
    return float(np.median(np.hypot(offset[..., 0][obj] - gx[obj] - OPT_T[0],
                                    offset[..., 1][obj] - gy[obj] - OPT_T[1])))


@pytest.fixture(scope="module")
def opt_gn(card):
    """gaussNewtonGPU at OPT_SCHEDULE on the frame: (Offset, costs, the
    launches it made)."""
    zero_counts()
    off, costs, _ = _opt_lifecycle("gaussNewtonGPU", OPT_SCHEDULE, card,
                                   _opt_frame_problem())
    return off, costs, read_counts()


@pytest.mark.cuda
def test_opt_gauss_newton(opt_gn):
    """The object's median |flow − t| < 1 px; each outer iteration's final
    cost below OPT_DROP of its start; one pcg_fixed launch a step and no
    other kernel."""
    off, costs, launches = opt_gn
    n_outer, n_iter, _ = OPT_SCHEDULE
    assert _object_error(off, _opt_frame_problem()[0]) < 1.0
    assert max(r[-1] / r[0] for r in costs) < OPT_DROP
    assert launches["pcg_fixed"] == n_outer * n_iter
    assert sum(launches.values()) == launches["pcg_fixed"]


@pytest.mark.cuda
def test_opt_levenberg_marquardt(card, opt_gn):
    """LMGPU at LM_OUTER outer iterations: median |flow − t| < 1 px, mean
    |flow_LM − flow_GN| < 2 px over the object (scripts/lm_check.py's
    bound), an accepted step in every outer iteration and every outer
    iteration's final cost below OPT_DROP of its start (the problem is a
    pure translation, exactly solvable: a solver that barely moves
    fails)."""
    problem = _opt_frame_problem()
    obj = problem[0] == 0
    _, n_iter, l_iter = OPT_SCHEDULE
    off, costs, acc = _opt_lifecycle("LMGPU", (LM_OUTER, n_iter, l_iter),
                                     card, problem)
    assert _object_error(off, problem[0]) < 1.0
    assert float(np.mean(np.hypot(*(off - opt_gn[0])[obj].T))) < 2.0
    assert all(any(a) for a in acc)
    assert max(r[-1] / r[0] for r in costs) < OPT_DROP


OPT_CARD_CASES = [(kind, prob, sched) for kind in ("gaussNewtonGPU", "LMGPU")
                  for prob, sched in (("frame", (2, 2, 60)),
                                      ("grid", (1, 4, 80)))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,prob,sched", OPT_CARD_CASES,
                         ids=[f"{k}-{p}" for k, p, _ in OPT_CARD_CASES])
def test_opt_facade_on_the_card_matches_the_cpu(card, kind, prob, sched):
    """Both solver kinds on the card within 0.05 px of the CPU's plain
    torch; GN one pcg_fixed launch a step, LM none; an lIterations = 0
    solve leaves the bound buffers bitwise unchanged."""
    problem = (_opt_frame_problem if prob == "frame" else _opt_grid_problem)()
    zero_counts()
    gpu = _opt_lifecycle(kind, sched, card, problem)[0]
    launches = read_counts()["pcg_fixed"]
    cpu = _opt_lifecycle(kind, sched, "cpu", problem)[0]
    assert float(np.abs(gpu - cpu).max()) < 0.05
    assert launches == (sched[0] * sched[1] if kind == "gaussNewtonGPU"
                        else 0)
    arap_mask, src, tgt = problem
    H, W = arap_mask.shape
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1)
    angle = np.zeros((H, W), np.float32)
    before = offset.tobytes(), angle.tobytes()
    state = opt.Opt_NewState(device=card)
    plan = opt.Opt_ProblemPlan(state, opt.Opt_ProblemDefine(
        state, "arap_plan.t", "gaussNewtonGPU"), (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", 1)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", 0)
    cons = np.full((H, W, 2), -1.0, np.float32)
    cons[src[:, 1].astype(int), src[:, 0].astype(int)] = tgt
    opt.Opt_ProblemSolve(state, plan, [offset, angle, offset.copy(), cons,
                                       (arap_mask != 0).astype(np.float32),
                                       np.float32(10.0),
                                       np.float32(np.sqrt(0.01))])
    assert (offset.tobytes(), angle.tobytes()) == before


@pytest.mark.cuda
def test_generic_solver_matches_kernel_solve(card):
    """generic.gn_solve (torch.func) on a 192x384 crop around the Opt
    object, and the graph energy (grid_edges) through it, against the
    specialised solve (the PCG kernel, one launch a step) at 1x3x80: max
    |Δx| < 0.01 over the solve region."""
    from arap_flow_tpu_torch.ops import generic as G
    from arap_flow_tpu_torch.ops import graph as GR

    arap_mask, src, tgt = _opt_frame_problem()
    ch, cw = 192, 384
    gn_iters, pcg_iters = 3, 80
    ys, xs = np.where(arap_mask == 0)
    y0 = min(max(int(ys.mean()) - ch // 2, 0), FRAME_H - ch)
    x0 = min(max(int(xs.mean()) - cw // 2, 0), FRAME_W - cw)
    m = arap_mask[y0 : y0 + ch, x0 : x0 + cw]
    assert (m == 0).sum() == (arap_mask == 0).sum()  # the object fits
    c = np.concatenate([src, tgt], 1).astype(np.int64) - [x0, y0, x0, y0]
    keep = ((c[:, 0] >= 0) & (c[:, 0] < cw) & (c[:, 1] >= 0) & (c[:, 1] < ch)
            & (c[:, 2] >= 0) & (c[:, 2] < cw) & (c[:, 3] >= 0)
            & (c[:, 3] < ch))
    ops = E.build_operands(m, add_border_pins(c[keep].astype(np.int32), cw,
                                              ch), device=card)
    cimg = E.anneal_constraints(ops, 1.0)
    zero_counts()
    x_spec, _ = S.solve(ops, S.SolverConfig(num_anneal=1, gn_iters=gn_iters,
                                            max_pcg_iters=pcg_iters,
                                            pcg_iters=float(pcg_iters)))
    assert read_counts()["pcg_fixed"] == gn_iters

    def diag_fn(x):
        return E.jtf_and_diag(x, ops, cimg)[1]

    x_gen = G.gn_solve(lambda x: E.residuals(x, ops, cimg), E.init_state(ops),
                       gn_iters, pcg_iters, diag_fn=diag_fn)
    edges = torch.as_tensor(GR.grid_edges(m), device=card)
    ur = ops.grid.reshape(2, -1)
    verts = torch.nonzero(ops.fitmask.reshape(-1) > 0)[:, 0]
    tgts = cimg.reshape(2, -1)[:, verts].T

    def graph_residuals(xf):
        return (GR.arap_graph_residuals(xf, edges, ur, torch.sqrt(ops.wr2)),
                GR.fit_graph_residuals(xf, verts, tgts, torch.sqrt(ops.wf2)))

    x_graph = G.gn_solve(graph_residuals, E.init_state(ops).reshape(3, -1),
                         gn_iters, pcg_iters,
                         diag_fn=lambda xf: diag_fn(
                             xf.reshape(3, ch, cw)).reshape(3, -1))
    act = ops.mask > 0
    assert float((x_gen - x_spec).abs()[:, act].max()) < 0.01
    assert float((x_graph.reshape(3, ch, cw) - x_spec).abs()[:, act].max()
                 ) < 0.01


@pytest.mark.cuda
def test_solve_instrumented(card, pair, tmp_path):
    """solve_instrumented on the pair's first segment at 19x8x400: 152
    finite costs, x bitwise solve's, 152 pcg_fixed launches; the CSV
    (save_solver_iterations) and a non-empty device trace holding the PCG
    kernel."""
    from arap_flow_tpu_torch.utils import profiling as PR

    ops = E.expand_operands(E.CompactOperands.stack([pair[1][0].ops]).to(card))
    cfg = S.SolverConfig()
    n = cfg.num_anneal * cfg.gn_iters
    zero_counts()
    x, _, costs, _ = PR.profile_solve(ops, cfg)
    assert read_counts()["pcg_fixed"] == n
    assert torch.equal(x, S.solve(ops, cfg)[0])
    assert costs.shape == (1, n) and np.isfinite(costs).all()
    csv = str(tmp_path / "iterations.csv")
    PR.save_solver_iterations(csv, costs[0])
    with open(csv) as f:
        assert len(f.read().splitlines()) == n + 1
    logdir = str(tmp_path / "trace")
    with PR.device_trace(logdir):
        S.solve_instrumented(ops, cfg._replace(num_anneal=1, gn_iters=2))
        torch.cuda.synchronize()
    traces = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    assert sum(os.path.getsize(p) for p in traces) > 0
    with open(traces[0]) as f:
        assert "pcg_cluster" in f.read()


@pytest.mark.cuda
def test_mesh_runner_on_one_card(card, pair):
    """BatchRunner on make_mesh([cuda:0, cuda:0]) against the unsharded
    runner on the pair's tasks three times over (a chunk of 3 a bucket,
    split 2 + 1), at 19x8x400: the same keys, max |Δflow| < 1e-4 px,
    bitwise where the PCG plans of B = 3, 2 and 1 agree, pcg_fixed
    launched. Two mesh entries on one card test the split and the gather,
    not scaling."""
    many = [t.__class__(**{**vars(t), "pair_idx": k}) for k in range(3)
            for t in pair[1] if t is not None]
    runs = []
    for m in (None, make_mesh(devices=[card, card])):
        runner = BatchRunner(S.SolverConfig(), device=card, mesh=m)
        zero_counts()
        for t in many:
            runner.add(t)
        runs.append((runner.finish(), read_counts()["pcg_fixed"]))
        torch.cuda.synchronize()
    (ref, _), (got, got_n) = runs
    assert sorted(got) == sorted(ref) and got_n > 0
    assert max(float(np.abs(got[k].flow - ref[k].flow).max())
               for k in ref) < 1e-4
    plans = [[card_plan(B, *hw, False, card) for B in (3, 2, 1)]
             for hw in {t.ops.mask_u8.shape for t in many}]
    if all(p[0] == p[1] == p[2] for p in plans):
        assert _same_products(got, ref)


def _frame_batch(probs, device, copies: int = 1) -> E.ArapOperands:
    """Segment 0 of the pair on the whole frame, `copies` times stacked."""
    _, mask, cons, _ = probs[0]
    ops = E.build_operands(mask, add_border_pins(cons, FRAME_W, FRAME_H),
                           device=device)
    return E.ArapOperands(**{f: torch.stack([v] * copies)
                             for f, v in vars(ops).items()})


@pytest.mark.cuda
def test_solve_spatial_on_one_card(card, pair):
    """solve_spatial at 480x854 over [cuda:0]*4 (space = 4) and [cuda:0]
    against solver.solve at the cut schedule: max |Δx| and |Δflow| < 5e-4
    against the plain backend (the same arithmetic, summed in another
    order), < 0.05 px against the PCG kernel's route."""
    batch = _frame_batch(pair[0], card)
    plain = cut_config(backend="plain")
    x_p, f_p = S.solve(batch, plain)
    _, f_k = S.solve(batch, cut_config())
    for space in (4, 1):
        mesh = make_mesh(devices=[card] * space, space=space)
        x, flow = solve_spatial(batch, plain, mesh)
        assert bool(torch.isfinite(x).all())
        assert float((x - x_p).abs().max()) < 5e-4
        assert float((flow - f_p).abs().max()) < 5e-4
        assert float((flow - f_k).abs().max()) < 0.05


def _segment_crop(prob, task):
    """The pair's segment on its task's canonical solve box: (mask, pinned
    constraints in the box, y0, x0), as make_task cuts it before any
    transposition."""
    _, mask, cons, _ = prob
    bh, bw = task.bucket
    pinned = add_border_pins(cons, FRAME_W, FRAME_H).astype(np.int64)
    sub = np.ascontiguousarray(mask[task.y0 : task.y0 + bh,
                                    task.x0 : task.x0 + bw])
    shifted = pinned.copy()
    shifted[:, [0, 2]] -= task.x0
    shifted[:, [1, 3]] -= task.y0
    inside = ((shifted[:, 0] >= 0) & (shifted[:, 0] < bw)
              & (shifted[:, 1] >= 0) & (shifted[:, 1] < bh))
    return sub, shifted[inside].astype(np.int32)


@pytest.mark.cuda
def test_pyramid(card, pair):
    """solve_pyramid on the pair's first segment's solve box: the card
    against the CPU at the cut schedule (max |Δflow| < 1e-3 px); at
    19x8x400 with fine_anneal = 1, 19x8 coarse + 1x8 fine pcg_fixed
    launches and a finite flow."""
    from arap_flow_tpu_torch.ops.pyramid import solve_pyramid

    sub, cons = _segment_crop(pair[0][0], pair[1][0])
    _, f_gpu = solve_pyramid(sub, cons, cut_config(), device=card)
    _, f_cpu = solve_pyramid(sub, cons, cut_config(), device="cpu")
    assert float((f_gpu.cpu() - f_cpu).abs().max()) < 1e-3
    full = S.SolverConfig()
    zero_counts()
    _, f_pyr = solve_pyramid(sub, cons, full, fine_anneal=1, device=card)
    assert read_counts()["pcg_fixed"] == (full.num_anneal * full.gn_iters
                                          + full.gn_iters)
    assert bool(torch.isfinite(f_pyr).all())


@pytest.mark.cuda
def test_host_raster_deform_list(card, pair, tmp_path, monkeypatch):
    """ARAP_RASTER=host deform on a list of the pair's two frames at the
    cut schedule: the native splat runs once a frame, no frame fails, and
    the products are byte-identical to ArapDeformer(raster="host")'s, frame
    by frame."""
    from arap_flow_tpu_torch.native import runtime
    from arap_flow_tpu_torch.pipeline import deform_tool
    from arap_flow_tpu_torch.utils.config import FrameworkConfig

    cfg = cut_config()
    calls = []
    splat = runtime.rasterize_warp

    def spy(*a, **k):
        calls.append(1)
        return splat(*a, **k)

    frames = []
    for j, (rgb, mask, cons, _) in enumerate(pair[0]):
        paths = [str(tmp_path / f"{n}{j}.{e}") for n, e in (
            ("rgb", "png"), ("mask", "png"), ("cstr", "txt"),
            ("flow", "flo"), ("w", "png"), ("m", "png"))]
        save_image(paths[0], rgb)
        save_image(paths[1], mask)
        with open(paths[2], "w") as f:
            f.write(f"{len(cons)}\n" + "\n".join(
                " ".join(str(v) for v in row) for row in cons))
        frames.append(deform_tool.FramePaths(*paths))
    with monkeypatch.context() as m:
        m.setattr(runtime, "rasterize_warp", spy)
        failed = deform_tool.deform_frames(
            frames, cfg, device=card,
            fw=FrameworkConfig(solver=cfg, raster="host"))
    assert len(calls) == len(frames) and not failed
    deformer = ArapDeformer(cfg, raster="host", device=card)
    for j, (rgb, mask, cons, _) in enumerate(pair[0]):
        res = deformer.deform(rgb, mask, cons)
        ref = [str(tmp_path / f"ref{j}.{e}") for e in ("flo", "w.png",
                                                        "m.png")]
        flow_write(ref[0], res.flow)
        save_image(ref[1], res.warped_rgb)
        save_image(ref[2], res.warped_mask)
        fr = frames[j]
        for a, b in zip((fr.out_flo, fr.out_rgb, fr.out_mask), ref):
            assert read_bytes(a) == read_bytes(b), (j, a)


@pytest.mark.cuda
def test_run_tasks(card, pair):
    """run_tasks on the pair's tasks plus segment 0 again as a full-frame
    fallback, at the cut schedule: bitwise equal to a BatchRunner fed the
    same, pcg_fixed launched."""
    cfg = cut_config()
    rgb, mask, cons, _ = pair[0][0]
    fallback = (1, 0, rgb, mask, add_border_pins(cons, FRAME_W, FRAME_H))
    live = [t for t in pair[1] if t is not None]
    zero_counts()
    got = run_tasks(live, [fallback], cfg, device=card)
    assert read_counts()["pcg_fixed"] > 0 and (1, 0) in got
    runner = BatchRunner(cfg, device=card)
    for t in live:
        runner.add(t)
    runner.add_fallback(*fallback)
    assert _same_products(got, runner.finish())


@pytest.mark.cuda
def test_mesh_paths_across_cards(card, tmp_path):
    """With every visible card on a mesh (two or more): BatchRunner against
    the unsharded runner on the first card, on the pair's tasks repeated
    once a card, at 19x8x400: max |Δflow| < 1e-4 px; solve_spatial of two
    copies of segment 0 on the whole frame at data = 1 (the rows over every
    card) and data = 2, against solver.solve on the plain backend at the
    cut schedule: max |Δx| < 5e-4; para_gen --mode sharded against --mode
    batched on the para_gen tree at 19x8x400, in turns: the products
    byte-identical."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"{n} CUDA device; the mesh paths need two or more")
    devs = [torch.device("cuda", i) for i in range(n)]
    probs, tasks = make_tasks()
    many = [t.__class__(**{**vars(t), "pair_idx": k}) for k in range(n)
            for t in tasks if t is not None]
    runs = []
    for m in (None, make_mesh()):
        runner = BatchRunner(S.SolverConfig(), device=card, mesh=m)
        for t in many:
            runner.add(t)
        runs.append(runner.finish())
    assert max(float(np.abs(runs[1][k].flow - runs[0][k].flow).max())
               for k in runs[0]) < 1e-4

    batch = _frame_batch(probs, card, copies=2)
    plain = cut_config(backend="plain")
    x_p, _ = S.solve(batch, plain)
    for data in (1, 2):
        m = make_mesh(data=data, space=n // data,
                      devices=devs[: n // data * data])
        x, _ = solve_spatial(batch, plain, m)
        assert float((x.to(card) - x_p).abs().max()) < 5e-4, m.shape

    inp = str(tmp_path / "in")
    make_pipeline_tree(inp)
    digests = []
    for k, mode in enumerate(("batched", "sharded", "batched", "sharded")):
        out = str(tmp_path / f"{mode}{k}")
        flags = para_gen.PipelineFlags(input=inp, output=out, multseg=True,
                                       seed=0, mode=mode, device=str(card))
        digests.append(tree_digest(out, para_gen.main_pipeline(
            flags, solver_cfg=S.SolverConfig())))
    assert all(d == digests[0] for d in digests)
