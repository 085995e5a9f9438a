"""The port's CUDA kernels against their plain versions on the card: the
build, the PCG kernel (``pcg_fixed``, standard and tall layouts) in each of
its plans, ``solve_batch``, the ZNCC search (``zncc_search``), the fused
whole-schedule kernel (``anneal_solve_fused``) and the crop-bucket ladder.
Every test needs the card and skips without it; the plans themselves are
checked on the CPU in tests/test_torch_pcg_plan.py and
tests/test_torch_fused_plan.py.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch import _build
from arap_flow_tpu_torch.models.arap import CROP_BUCKETS
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import fused_solver as F
from arap_flow_tpu_torch.ops import pcg as P
from arap_flow_tpu_torch.ops import solver as S
from arap_flow_tpu_torch.pipeline.batch import max_chunk_for
from torch_card import card  # noqa: F401
from torch_card import (FRAME_H, FRAME_W, SINTEL_H, SINTEL_W,
                        assert_zncc_matches_plain, cut_config,
                        jittered_operands,
                        jittered_pcg_problem, pcg_problem, read_counts,
                        relative_residuals, segment_operands, stack_operands,
                        zero_counts, zncc_inputs)


@pytest.mark.cuda
def test_builds_and_loads_every_library(card):
    """nvcc builds the three CUDA libraries (one process a source, started
    together) while g++ builds the host library beside them; all load."""
    with ThreadPoolExecutor(1) as ex:
        native = ex.submit(_build.build_native)
        _build.build()
        native.result()
    for stem in ("pcg", "zncc", "fused_solver"):
        _build.load(stem)
    _build.load_native()


# At 160 iterations CG has converged on these problems: the plain version
# reaches ≤ 3e-7·‖b‖ at every shape (CPU run), so a bound of 1e-5·‖b‖ does
# not depend on where CG stands in its oscillation, as a ratio of two
# residuals after fewer iterations does.
CONVERGED_ITERS = 160
# (B, H, W) of the PCG checks: a thin one (one row a CTA), B = 3, the
# pipeline's chunk, the largest resident bucket, the two spread shapes (the
# full frame and the largest bucket), a streamed one (a band's state does
# not fit a block's shared memory, so p lives in device memory), the
# pipeline's largest chunk (MAX_CHUNK of the smallest bucket), a batch
# large enough for one-CTA clusters, an odd width (one pixel a thread; even
# widths take pixel pairs) and the deform pair's two calls (solve_calls).
PCG_SHAPES = ((1, 16, 128), (3, 224, 384), (4, 192, 256), (1, 384, 640),
              (1, 480, 854), (1, 512, 896), (1, 576, 1024), (24, 64, 128),
              (72, 16, 128), (3, 33, 85), (1, 192, 384), (1, 288, 128))
PCG_KINDS = {(480, 854): "spread", (512, 896): "spread",
             (576, 1024): "streamed"}
# the shared-region problems at each shape (seeded 10·H + W, and 8 at the
# thin, spread, streamed and largest-chunk shapes), and
# tests/test_pallas_batched.py's batch of three problems with their own
# jittered constraints (state seed 19)
PCG_CASES = ([(*s, "grid", 10 * s[1] + s[2]) for s in PCG_SHAPES]
             + [(*s, "grid", 8) for s in ((1, 16, 128), (1, 480, 854),
                                          (1, 576, 1024), (24, 64, 128))]
             + [(3, 16, 128, "jittered", 19)])


@pytest.mark.cuda
@pytest.mark.parametrize("tall", [False, True], ids=["standard", "tall"])
@pytest.mark.parametrize("B,H,W,kind,seed", PCG_CASES,
                         ids=[f"B{b}-{h}x{w}-{k}{s}"
                              for b, h, w, k, s in PCG_CASES])
def test_pcg_kernel_matches_plain(card, B, H, W, kind, seed, tall):
    """The plan (resident, spread or streamed as the shape asks; the card
    holds the whole batch at once); 1 iteration within 1e-4 of the plain
    version; at 160 iterations both converged (‖b − JtJ·δ‖ ≤ 1e-5·‖b‖ for
    every problem) with max |Δδ| < 0.01; two runs bitwise equal; one launch
    a call; the tall layout within 1e-5 of the standard one."""
    plan = P.card_plan(B, H, W, tall, card)
    assert plan.kind == PCG_KINDS.get((H, W), "resident")
    assert P.active_clusters(plan, B, W, tall, card) >= B
    if kind == "grid":
        ops, args = pcg_problem(B, H, W, seed, card)
    else:
        ops, args = jittered_pcg_problem(range(B), seed, H, W, card)
    p1 = P.pcg_fixed_plain(*args, 1)
    pn = P.pcg_fixed_plain(*args, CONVERGED_ITERS)
    key = "pcg_fixed_tall" if tall else "pcg_fixed"
    n0 = P.LAUNCHES[key]
    k1 = P.pcg_fixed(*args, 1, tall=tall)
    kn = P.pcg_fixed(*args, CONVERGED_ITERS, tall=tall)
    assert torch.equal(kn, P.pcg_fixed(*args, CONVERGED_ITERS, tall=tall))
    assert P.LAUNCHES[key] == n0 + 3
    torch.testing.assert_close(k1, p1, rtol=1e-4, atol=1e-4)
    assert max(relative_residuals(ops, args, kn)) <= 1e-5
    assert max(relative_residuals(ops, args, pn)) <= 1e-5
    assert float((kn - pn).abs().max()) < 0.01
    if tall:
        s0 = P.LAUNCHES["pcg_fixed"]
        d = max(float((k1 - P.pcg_fixed(*args, 1, tall=False)).abs().max()),
                float((kn - P.pcg_fixed(*args, CONVERGED_ITERS, tall=False))
                      .abs().max()))
        assert d <= 1e-5
        assert P.LAUNCHES["pcg_fixed"] == s0 + 2


def _closed_form_iterations(cfg) -> float:
    return cfg.gn_iters * sum(
        min(cfg.max_pcg_iters, cfg.pcg_iters_early
            if cfg.pcg_iters_early > 0 and i < cfg.anneal_split
            else cfg.pcg_iters) for i in range(cfg.num_anneal))


def _per_problem_gap(probs, flows, cfg) -> float:
    return max(float((flows[k] - S.solve(o, cfg)[1]).abs().max())
               for k, o in enumerate(probs))


def _batch_problems(case, device):
    if case == "segments":  # the pipeline's chunk shape
        return segment_operands(4, 192, 256, seed=300, device=device)
    probs = [jittered_operands(s, 16, 128, device) for s in range(3)]
    return probs, stack_operands(probs)


SHORT = S.SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=60,
                       pcg_iters=60.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,cfg", [("segments", SHORT),
                                      ("jittered", cut_config())],
                         ids=["B4-192x256-3x2x60", "B3-16x128-2x2x40"])
def test_solve_batch_matches_per_problem_and_plain(card, case, cfg):
    """solve_batch on the card: within 1e-4 of per-problem solves; against
    the kernel route's plain version (backend "cuda" on CPU tensors) max
    |Δflow| < 0.05 px, median < 0.005 px; every problem ran the closed-form
    iteration count, also under an early/late split schedule."""
    probs, batch = _batch_problems(case, card)
    _, cpu_batch = _batch_problems(case, "cpu")
    _, flows = S.solve_batch(batch, cfg)
    _, f_cpu = S.solve_batch(cpu_batch, cfg._replace(backend="cuda"))
    d = (flows.cpu() - f_cpu).abs()
    assert _per_problem_gap(probs, flows, cfg) <= 1e-4
    assert float(d.max()) < 0.05 and float(d.median()) < 0.005
    for c in (cfg, cfg._replace(num_anneal=4, gn_iters=1,
                                pcg_iters_early=20.0, anneal_split=2.0)):
        _, _, n = S.solve_stats(batch, c)
        assert float(n.min()) == float(n.max()) == _closed_form_iterations(c)


@pytest.mark.cuda
def test_solve_batch_full_schedule_both_layouts(card, monkeypatch):
    """solve_batch on the pipeline's chunk at 19x8x400, standard and under
    ARAP_TALL_KERNEL=1: one launch of the layout's kernel a GN step and none
    of the other; within 1e-4 of per-problem solves; the tall flows within
    1e-5 of the standard ones."""
    probs, batch = segment_operands(4, 192, 256, seed=300, device=card)
    full = S.SolverConfig()
    steps = full.num_anneal * full.gn_iters
    runs = {}
    for tall in (False, True):
        if tall:
            monkeypatch.setenv("ARAP_TALL_KERNEL", "1")
        zero_counts()
        _, flows = S.solve_batch(batch, full)
        torch.cuda.synchronize()
        runs[tall] = flows, read_counts()
    monkeypatch.delenv("ARAP_TALL_KERNEL")
    (f_std, n_std), (f_tall, n_tall) = runs[False], runs[True]
    assert (n_std["pcg_fixed"], n_std["pcg_fixed_tall"]) == (steps, 0)
    assert (n_tall["pcg_fixed"], n_tall["pcg_fixed_tall"]) == (0, steps)
    assert _per_problem_gap(probs, f_std, full) <= 1e-4
    assert float((f_tall - f_std).abs().max()) <= 1e-5


# (N1, N2, H, W, radius): the searches of one matcher call on a sub-batch
# of 4 pairs at 854x480 (levels 3, radius 100: the coarse bank of 8 lanes
# x 5 hypotheses at r = 13, then one refine per level at r = 2); the coarse
# bank of the 13 STRETCH_HYPOTHESES, the largest coarse radius
# clamp_match_params allows at 854x480 (60), two ragged shapes (planes
# smaller than a warp's 21x32 tile, odd sizes) and one pair as 2-D planes
# (tests/test_pallas_match.py's smoothed noise moved by (2, -3)).
ZNCC_SHAPES = ((8, 40, 60, 106, 13), (8, 8, 120, 213, 2),
               (8, 8, 240, 427, 2), (8, 8, 480, 854, 2),
               (8, 104, 60, 106, 13), (8, 40, 60, 106, 60),
               (3, 6, 45, 70, 7), (1, 3, 19, 37, 5), (1, 1, 45, 70, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("N1,N2,H,W,r", ZNCC_SHAPES,
                         ids=[f"{a}to{b}-{h}x{w}-r{r}"
                              for a, b, h, w, r in ZNCC_SHAPES])
def test_zncc_kernel_matches_plain(card, N1, N2, H, W, r):
    if N1 == N2 == 1:
        a, b = _smoothed_pair(H, W, 2, -3, 15)
    else:
        a, b = zncc_inputs(N1, N2, H, W, r, seed=H + W + r)
    assert_zncc_matches_plain(torch.as_tensor(a, device=card),
                              torch.as_tensor(b, device=card), r)


def _smoothed_pair(H, W, dy, dx, seed):
    """tests/test_pallas_match.py's fixture: 3x3-smoothed noise and the
    same moved by (dy, dx), as 2-D planes."""
    from scipy.signal import convolve2d

    rng = np.random.default_rng(seed)
    a = convolve2d(rng.normal(size=(H + 40, W + 40)).astype(np.float32),
                   np.ones((3, 3), np.float32) / 9.0, mode="same")
    p1 = a[20 : 20 + H, 20 : 20 + W]
    p2 = a[20 + dy : 20 + dy + H, 20 + dx : 20 + dx + W]
    return (np.ascontiguousarray(p1, np.float32),
            np.ascontiguousarray(p2, np.float32))


def _sched(na, gn, it) -> S.SolverConfig:
    return S.SolverConfig(num_anneal=na, gn_iters=gn, max_pcg_iters=it,
                          pcg_iters=float(it))


def _fused_problems(B, H, W, kind, seed, device) -> E.ArapOperands:
    if kind == "jittered":
        return stack_operands([jittered_operands(seed + k, H, W, device)
                               for k in range(B)])
    return segment_operands(B, H, W, seed, device)[1]


def _assert_fused_plan_fits(B, H, W, device) -> None:
    plan = F.card_plan(B, H, W, device)
    assert F.active_clusters(plan, B, device) > 0, plan


# (B, H, W), schedule, problems and seed of the fused checks: a thin problem
# (one row a CTA), the deform pair's larger bucket, the pipeline's chunk,
# its largest chunk (B = 24 of the smallest bucket) and the full frame (the
# streamed plan), on segments; the thin problem, the largest chunk and the
# full frame also on tests/test_pallas_solver.py's jittered problems
# (seeds 6, 7, ...).
FUSED_CASES = (((1, 16, 128), (3, 2, 60), "jittered", 400),
               ((1, 16, 128), (3, 2, 60), "jittered", 6),
               ((1, 192, 384), (2, 2, 40), "segments", 592),
               ((4, 192, 256), (2, 2, 40), "segments", 592),
               ((24, 64, 128), (2, 2, 40), "segments", 464),
               ((1, FRAME_H, FRAME_W), (1, 2, 40), "segments", 880),
               ((24, 64, 128), (2, 2, 40), "jittered", 6),
               ((1, FRAME_H, FRAME_W), (1, 2, 40), "jittered", 6))
# Largest |Δx| over the solve region between the fused kernel and its
# plain version in the 1×1×3 and short-schedule checks: twice the largest
# reading, 5.05e-3 at 16×128 3×2×60 on an H100 80GB HBM3 at 700 W (both
# sides are deterministic).
FUSED_MAX_DX = 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sched,kind,seed", FUSED_CASES,
                         ids=[f"B{s[0]}-{s[1]}x{s[2]}-{k}{n}"
                              for s, _, k, n in FUSED_CASES])
def test_fused_kernel_matches_plain(card, shape, sched, kind, seed):
    """The plan fits the card; 1×1×1 within 1e-4 and 1×1×3 within
    FUSED_MAX_DX of the plain version; at the case's schedule, over the
    solve region, median |Δx| < 1e-3 and max |Δx| < FUSED_MAX_DX, every
    problem's final cost within 5%; two runs bitwise equal, one launch
    each."""
    B, H, W = shape
    _assert_fused_plan_fits(B, H, W, card)
    batch = _fused_problems(B, H, W, kind, seed, card)
    # 1 and 3 PCG iterations of one GN step: the same arithmetic summed in
    # another order; 3 holds β and both rz parities. By the third iteration
    # rounding has grown to at most 8.4e-4 (B=4 192×256 on an H100 80GB
    # HBM3 at 700 W), while a stale β or rz moves x by 0.49 or more on
    # tests/test_torch_fused.py's problem
    short = [float((F.anneal_solve_fused(batch, _sched(1, 1, n))
                    - F.anneal_solve_fused_plain(batch, _sched(1, 1, n))
                    ).abs().max()) for n in (1, 3)]
    assert short[0] < 1e-4 and short[1] < FUSED_MAX_DX
    cfg = _sched(*sched)
    n0 = F.LAUNCHES["anneal_solve_fused"]
    k = F.anneal_solve_fused(batch, cfg)
    assert torch.equal(k, F.anneal_solve_fused(batch, cfg))
    assert F.LAUNCHES["anneal_solve_fused"] == n0 + 2
    p = F.anneal_solve_fused_plain(batch, cfg)
    # over the solve region only: elsewhere x stays at the grid in both
    d = (k - p).abs()[batch.mask[:, None].expand_as(k) > 0]
    assert float(d.median()) < 1e-3 and float(d.max()) < FUSED_MAX_DX
    cimg = E.anneal_constraints(batch, 1.0)
    ck, cp = E.cost(k, batch, cimg), E.cost(p, batch, cimg)
    assert float(((ck - cp).abs()
                  / torch.clamp(cp.abs(), min=1e-30)).max()) < 0.05


# Every crop bucket at B = 1 and at the pipeline's largest chunk
# (max_chunk_for), and the two full frames a fallback solves alone (B = 1)
LADDER = ([(H, W, max_chunk_for((H, W))) for H, W in CROP_BUCKETS]
          + [(SINTEL_H, SINTEL_W, 1), (FRAME_H, FRAME_W, 1)])
LADDER_REPEAT_ITERS = 40  # the bitwise repeat and the tall check


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,Bmax", LADDER,
                         ids=[f"{h}x{w}-B{b}" for h, w, b in LADDER])
def test_bucket_ladder(card, H, W, Bmax):
    """At B = 1 and Bmax: the plans of both PCG layouts and the fused
    kernel fit the card; the PCG kernel within 1e-4 of its plain version
    after 1 iteration and bitwise repeatable at 40; the fused kernel within
    1e-4 of its plain version at 1x1x1; at Bmax the tall layout within 1e-5
    of the standard one."""
    ops, args = pcg_problem(Bmax, H, W, seed=H + 3 * W, device=card)
    batch = stack_operands(ops)
    for B in sorted({1, Bmax}):
        for tall in (False, True):
            plan = P.card_plan(B, H, W, tall, card)
            assert P.active_clusters(plan, B, W, tall, card) > 0, plan
        _assert_fused_plan_fits(B, H, W, card)
        a = tuple(t[:B] for t in args)
        k1 = P.pcg_fixed(*a, 1, tall=False)
        torch.testing.assert_close(k1, P.pcg_fixed_plain(*a, 1),
                                   rtol=1e-4, atol=1e-4)
        ka = P.pcg_fixed(*a, LADDER_REPEAT_ITERS, tall=False)
        assert torch.equal(ka, P.pcg_fixed(*a, LADDER_REPEAT_ITERS,
                                           tall=False))
        if B == Bmax:
            t1 = P.pcg_fixed(*a, 1, tall=True)
            ta = P.pcg_fixed(*a, LADDER_REPEAT_ITERS, tall=True)
            assert max(float((t1 - k1).abs().max()),
                       float((ta - ka).abs().max())) <= 1e-5
        sub = E.ArapOperands(**{f: v[:B] for f, v in vars(batch).items()})
        unit = _sched(1, 1, 1)
        assert float((F.anneal_solve_fused(sub, unit)
                      - F.anneal_solve_fused_plain(sub, unit)).abs().max()
                     ) < 1e-4
