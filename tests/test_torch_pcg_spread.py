"""The PCG kernel's spread plan on the card (``ops/pcg.py::spread_plan``,
``csrc/pcg.cu::pcg_cluster_spread``): one problem over the whole card, the
batch one problem after another, for the shapes whose p does not fit a
16-CTA cluster (MPI-Sintel's 436×1024 frame, the 480×854 frame).

Against ``pcg_fixed_plain`` at the tolerances of tests/test_torch_pcg.py:
1 and 2 iterations to rtol/atol 1e-4 (the same arithmetic, summed in
another order), 400 iterations converged (‖b − JtJ·δ‖ ≤ 1e-5·‖b‖ for both,
max |Δδ| < 0.01); two calls bitwise equal; one launch, one shape and one
spread-plan call counted a call; masks that are not all 0 or 1 (read from
L2, not packed into bits) the same way; a GN chain replayed from CUDA
graphs bitwise its eager steps. Every test needs the card and skips without it.
The plan itself is checked on the CPU in tests/test_torch_pcg_plan.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io.constraints import add_border_pins
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import graphs as G
from arap_flow_tpu_torch.ops import pcg as P
from arap_flow_tpu_torch.ops import solver as S

CONVERGED_ITERS = 400


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _problems(B, H, W, seed, device):
    """B numpy-seeded problems at H×W (an interior solve region with a
    constraint grid and border pins, linearised at a perturbed state):
    their operands and pcg_fixed's arguments."""
    mask = np.full((H, W), 255, np.uint8)
    mask[2:H - 2, 8:W - 8] = 0
    ys, xs = np.mgrid[3:H - 3:4, 10:W - 10:12]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 2, ys.ravel() - 1],
                    1).astype(np.int32)
    ops = E.build_operands(mask, add_border_pins(cons, W, H), device=device)
    x0, cimg = E.init_state(ops), E.anneal_constraints(ops, 1.0)
    parts = []
    for k in range(B):
        rng = np.random.default_rng(seed + k)
        x = x0 + 0.3 * torch.as_tensor(rng.standard_normal((3, H, W)),
                                       dtype=torch.float32, device=device)
        s, c = E.trig(x)
        jtf, diag = E.jtf_and_diag(x, ops, cimg)
        parts.append((-jtf, S.guarded_invert(diag), s, c))
    args = tuple(torch.stack([p[k] for p in parts]).contiguous()
                 for k in range(4))
    args += tuple(torch.stack([t] * B).contiguous()
                  for t in (ops.vmasks, ops.fitmask, ops.wf2, ops.wr2))
    return ops, args


def _residuals(ops, args, delta):
    """‖b − JtJ·δ‖ / ‖b‖ of every problem."""
    b, _, s, c = args[:4]
    return [float(torch.linalg.vector_norm(b[k] - E.apply_jtj(
        delta[k], ops, s[k], c[k])) / torch.linalg.vector_norm(b[k]))
        for k in range(b.shape[0])]


SPREAD_SHAPES = ((2, 436, 1024), (1, 480, 854))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 2, CONVERGED_ITERS])
@pytest.mark.parametrize("B,H,W", SPREAD_SHAPES,
                         ids=[f"B{b}-{h}x{w}" for b, h, w in SPREAD_SHAPES])
def test_spread_matches_plain(cuda_device, B, H, W, iters):
    plan = P.card_plan(B, H, W, False, cuda_device)
    assert plan.kind == "spread" and plan.cluster > P.MAX_CLUSTER
    assert P.active_clusters(plan, B, W, False, cuda_device) == 1
    ops, args = _problems(B, H, W, 10 * H + W, cuda_device)
    launches, shapes = dict(P.LAUNCHES), dict(P.LAUNCH_SHAPES)
    calls = P.PLAN_CALLS["spread"]
    k = P.pcg_fixed(*args, iters, tall=False)
    again = P.pcg_fixed(*args, iters, tall=False)
    plain = P.pcg_fixed_plain(*args, iters)
    torch.cuda.synchronize()
    assert torch.equal(k, again)
    if iters < CONVERGED_ITERS:
        torch.testing.assert_close(k, plain, rtol=1e-4, atol=1e-4)
    else:
        res, res_plain = _residuals(ops, args, k), _residuals(ops, args,
                                                              plain)
        assert max(res) <= 1e-5 and max(res_plain) <= 1e-5, (res, res_plain)
        assert float((k - plain).abs().max()) < 0.01
    assert P.LAUNCHES["pcg_fixed"] == launches["pcg_fixed"] + 2
    assert P.LAUNCH_SHAPES[(B, H, W)] == shapes.get((B, H, W), 0) + 2
    assert P.PLAN_CALLS["spread"] == calls + 2


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 2, CONVERGED_ITERS])
def test_spread_weighted_masks_match_plain(cuda_device, iters):
    """The fit mask weighted 0.5 over the top half of the rows: the CTAs
    of those bands read their masks from L2 every iteration, the others
    keep them as bits, in one launch; against the plain version as in
    ``test_spread_matches_plain``."""
    B, H, W = SPREAD_SHAPES[1]
    ops, args = _problems(B, H, W, 5, cuda_device)
    fit = args[5].clone()
    fit[:, :H // 2] *= 0.5
    args = (*args[:5], fit, *args[6:])
    assert bool(((fit != 0) & (fit != 1)).any())
    ops = dataclasses.replace(ops, fitmask=fit[0])
    k = P.pcg_fixed(*args, iters, tall=False)
    again = P.pcg_fixed(*args, iters, tall=False)
    plain = P.pcg_fixed_plain(*args, iters)
    torch.cuda.synchronize()
    assert torch.equal(k, again)
    if iters < CONVERGED_ITERS:
        torch.testing.assert_close(k, plain, rtol=1e-4, atol=1e-4)
    else:
        res, res_plain = _residuals(ops, args, k), _residuals(ops, args,
                                                              plain)
        assert max(res) <= 1e-5 and max(res_plain) <= 1e-5, (res, res_plain)
        assert float((k - plain).abs().max()) < 0.01


@pytest.mark.cuda
def test_spread_tall_layout_matches_standard(cuda_device):
    """The tall layout reads the halos across the stacked planes, which
    the zero direction masks multiply away: the same δ."""
    B, H, W = SPREAD_SHAPES[1]
    assert P.card_plan(B, H, W, True, cuda_device).kind == "spread"
    _, args = _problems(B, H, W, 3, cuda_device)
    for iters in (1, 40):
        std = P.pcg_fixed(*args, iters, tall=False)
        tall = P.pcg_fixed(*args, iters, tall=True)
        torch.testing.assert_close(tall, std, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_spread_gn_chain_replays_bitwise(cuda_device):
    """A GN chain at 436×1024 (its steps captured and replayed as CUDA
    graphs) against a hand loop of eager steps: bitwise, every step one
    spread-plan call, replays counted as the eager calls."""
    G.registry("gn step").clear()
    H, W = 436, 1024
    mask = np.full((H, W), 255, np.uint8)
    mask[4:H - 4, 6:W - 6] = 0
    ys, xs = np.mgrid[6:H - 6:8, 9:W - 9:16]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 3, ys.ravel() - 2],
                    1).astype(np.int32)
    ops = E.build_operands(mask, add_border_pins(cons, W, H),
                           device=cuda_device)
    cfg = S.resolve_for(ops, S.SolverConfig(
        num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0,
        backend="cuda"))
    x = E.init_state(ops)
    for i in range(cfg.num_anneal):
        alpha = np.float32(i + 1.0) / np.float32(cfg.num_anneal)
        cimg = E.anneal_constraints(ops, alpha)
        for _ in range(cfg.gn_iters):
            x, _ = S.gn_step(x, ops, cimg, cfg, cfg.pcg_iters, 0.0, 0.0)
    calls = P.PLAN_CALLS["spread"]
    got, _ = S._per_gn_solve(ops, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, x)
    assert P.PLAN_CALLS["spread"] == calls + cfg.num_anneal * cfg.gn_iters
