"""The port's two-level warm start (``ops/pyramid.py``) against the JAX
package's.

- ``coarsen_problem``: every operand plane equal to JAX's, at even and odd
  fine sizes (20×30 → 10×15, 20×29 → 10×14: both packages round down).
- The ×2 upsample: ``F.interpolate`` (bilinear, half-pixel centres) equals
  ``jax.image.resize(..., "bilinear")`` within 1e-5 at even and odd output
  sizes (the border weights renormalise the same way).
- ``solve_pyramid`` at 2×2×40 with ``fine_anneal`` 1 and 2: flows within
  0.05 px of JAX's (the port's short-schedule solve bound,
  tests/test_torch_solver.py), and the translation case of
  tests/test_pyramid.py recovered within 0.5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import pyramid as JP
from arap_flow_tpu.ops.solver import SolverConfig as JConfig
from arap_flow_tpu_torch.ops import pyramid as TP
from arap_flow_tpu_torch.ops.solver import SolverConfig as TConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHORT = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)
FLOW_TOL = 0.05


def _problem(H, W, seed=0):
    """An object inset from the border, a constraint every 3 px moved by a
    small rotation and translation, and the border pins."""
    rng = np.random.default_rng(seed)
    mask = np.full((H, W), 255, np.uint8)
    mask[3 : H - 3, 4 : W - 4] = 0
    ys, xs = np.mgrid[4 : H - 4 : 3, 5 : W - 5 : 3]
    th, cx, cy = 0.05, W / 2, H / 2
    xr = np.cos(th) * (xs - cx) - np.sin(th) * (ys - cy) + cx + 2
    yr = np.sin(th) * (xs - cx) + np.cos(th) * (ys - cy) + cy - 1
    cons = np.stack([xs.ravel(), ys.ravel(), np.round(xr).ravel(),
                     np.round(yr).ravel()], 1).astype(np.int32)
    cons = cons[rng.permutation(len(cons))]
    return mask, add_border_pins(cons, W, H)


@pytest.mark.parametrize("H,W,hw2", [(20, 30, (10, 15)), (20, 29, (10, 14)),
                                     (33, 40, (16, 20))])
def test_coarsen_problem_equals_jax(H, W, hw2):
    mask, cons = _problem(H, W)
    # a duplicate source after halving: the later one wins in both
    cons = np.concatenate([cons, [[10, 8, 12, 9], [11, 9, 16, 13]]]).astype(
        np.int32)
    jops, jhw = JP.coarsen_problem(mask, cons, JE.ArapWeights())
    tops, thw = TP.coarsen_problem(mask, cons, device=CPU)
    assert jhw == thw == hw2
    for f in vars(tops):
        np.testing.assert_array_equal(getattr(tops, f).numpy(),
                                      np.asarray(getattr(jops, f)), err_msg=f)
    assert float(tops.fitmask[4, 5]) == 1.0  # (10, 8) // 2 = (5, 4)


@pytest.mark.parametrize("hw,HW", [((10, 15), (20, 30)), ((10, 14), (20, 29)),
                                   ((16, 20), (33, 40))])
def test_upsample_equals_jax_image_resize(hw, HW):
    rng = np.random.default_rng(hw[1])
    a = rng.standard_normal((2, *hw)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(a), (2, *HW), "bilinear"))
    got = TP._upsample(torch.from_numpy(a), *HW).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("H,W,fine", [(24, 32, 1), (20, 29, 2)])
def test_solve_pyramid_matches_jax(H, W, fine):
    mask, cons = _problem(H, W, seed=H)
    jx, jflow = JP.solve_pyramid(mask, cons, JConfig(**SHORT, backend="xla"),
                                 fine_anneal=fine)
    tx, tflow = TP.solve_pyramid(mask, cons, TConfig(**SHORT),
                                 fine_anneal=fine, device=CPU)
    assert tx.shape == (3, H, W) and tflow.shape == (2, H, W)
    assert np.abs(tflow.numpy() - np.asarray(jflow)).max() < FLOW_TOL
    # excluded pixels stay at rest
    ex = mask != 0
    assert np.abs(tflow.numpy()[:, ex]).max() == 0.0


def test_pyramid_recovers_translation():
    """tests/test_pyramid.py's translation case, through the port."""
    H, W = 32, 40
    mask = np.zeros((H, W), np.uint8)
    ys, xs = np.mgrid[4 : H - 4 : 4, 4 : W - 4 : 4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 4, ys.ravel() + 2],
                    1)
    cons = add_border_pins(cons.astype(np.int32), W, H)
    cfg = TConfig(num_anneal=4, gn_iters=2, max_pcg_iters=80, pcg_iters=80.0)
    _, flow = TP.solve_pyramid(mask, cons, cfg, fine_anneal=2, device=CPU)
    f = flow.numpy()
    inner = (slice(8, H - 8), slice(8, W - 8))
    assert abs(np.median(f[0][inner]) - 4.0) < 0.5
    assert abs(np.median(f[1][inner]) - 2.0) < 0.5
