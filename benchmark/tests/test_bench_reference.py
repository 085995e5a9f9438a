"""The plain reference against the program's plain CPU path at a cut:
its solve, matcher and rasterizer, and whole runs of both cells."""

import numpy as np
import pytest
import torch

from benchmark.reference import arap, matcher, pipeline, raster
from benchmark.tests import cut


def _problem(H=40, W=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    mk = np.where(((yy - H / 2) / (H / 3)) ** 2
                  + ((xx - W / 2) / (W / 3)) ** 2 < 1, 0, 255).astype(np.uint8)
    ys, xs = np.mgrid[2:H:4, 2:W:4]
    sel = mk[ys, xs] == 0
    d = rng.integers(-3, 4, (sel.sum(), 2))
    cons = np.stack([xs[sel], ys[sel], xs[sel] + d[:, 0], ys[sel] + d[:, 1]],
                    1).astype(np.int32)
    from arap_flow_tpu_torch.io.constraints import add_border_pins

    return mk, add_border_pins(cons, W, H)


def test_solve_matches_the_programs_plain_solver():
    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops import solver as S

    cfg = S.SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=60,
                         pcg_iters=60.0)
    probs = [_problem(seed=s) for s in (0, 1)]
    # the reference pads the second problem into a larger plane
    P = arap.build([p[0] for p in probs], [p[1] for p in probs], 44, 70,
                   "cpu")
    xr = arap.solve(P, (3, 2, 60))
    for k, (mk, cons) in enumerate(probs):
        ops = E.expand_operands(E.build_compact(mk, cons).to("cpu"))
        x = S.anneal_solve(ops, cfg)
        obj = mk == 0
        got = (xr[k, :2, :40, :64] - P.grid[k, :, :40, :64]).numpy()
        want = (x[:2] - ops.grid).numpy()
        assert np.abs(got - want)[:, obj].max() < 1e-3


def test_matcher_matches_the_programs():
    from arap_flow_tpu_torch.ops.matching import match_images

    from benchmark.traffic import Scene

    sc = Scene(cut.DAVIS, 5)
    (a, ma), (b, _) = sc.frame(0), sc.frame(1)
    want = match_images(a, b, radius=100, roi_mask=ma,
                        device=torch.device("cpu"))[:, :4].astype(np.int32)
    got = matcher.match_pair(a, b, ma, "cpu")
    assert len(want) > 50
    assert np.array_equal(got, want)


def test_rasterizer_matches_the_programs():
    from arap_flow_tpu_torch.ops.rasterize import rasterize

    mk, _ = _problem()
    rng = np.random.default_rng(3)
    H, W = mk.shape
    warp = raster.make_grid(H, W, "cpu") + torch.tensor(
        rng.normal(0, 1.5, (2, H, W)), dtype=torch.float32)
    rgb = torch.tensor(rng.integers(0, 256, (3, H, W)), dtype=torch.float32)
    m = torch.tensor(mk)
    for a, b in zip(raster.rasterize(warp, rgb, m), rasterize(warp, rgb, m)):
        assert torch.equal(a, b)


def test_border_pins_are_the_programs():
    from arap_flow_tpu_torch.io.constraints import add_border_pins

    want = add_border_pins(np.zeros((0, 4), np.int32), 7, 5)
    got = pipeline.border_pins(7, 5)
    assert sorted(map(tuple, want)) == sorted(map(tuple, got))


@pytest.mark.parametrize("cell", sorted(cut.CELLS))
def test_a_run_at_the_cut_is_correct(cell):
    code, res = cut.run(cell)
    assert code == 0 and res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    from benchmark import harness

    manifest = harness.load_cell(cell)[0]
    assert set(res["metrics"]) == {m["name"] for m in harness.cell_metrics(
        manifest, cell, "end_to_end")}
    assert list(res)[-1] == "compared"
