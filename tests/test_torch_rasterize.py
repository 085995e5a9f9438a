"""The port's rasterizer agrees with the JAX package's device rasterizer on
identical warp inputs.

The products are integers (uint8 colours truncated from float32, a 0/255
mask), so they are compared for equality. Both sides evaluate the same
float32 expressions; a different fusion (an FMA contraction by XLA, say)
could move a value across a truncation boundary, which would show as a
handful of pixels. None do on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.ops import rasterize as JR
from arap_flow_tpu_torch.ops import rasterize as TR

torch.set_num_threads(1)


def _warp_case(kind: str, H=48, W=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    mask = np.full((H, W), 255, np.uint8)
    mask[((yy - 24) / 14) ** 2 + ((xx - 30) / 20) ** 2 < 1] = 0
    if kind == "rigid":
        th, dx, dy = 0.3, 5.0, 3.0
        wx = np.cos(th) * (xx - 30) - np.sin(th) * (yy - 24) + 30 + dx
        wy = np.sin(th) * (xx - 30) + np.cos(th) * (yy - 24) + 24 + dy
    elif kind == "wavy":
        wx = xx + 4 + 2 * np.sin(yy / 5)
        wy = yy - 2 + 3 * np.sin(xx / 4)
    elif kind == "fold":  # strong compression: quads fold over each other
        wx = xx + 6 * np.sin(xx / 3)
        wy = yy + 2 * np.cos(yy / 2)
    elif kind == "edge":  # the object is pushed across the frame edge
        wx = xx + 30
        wy = yy - 15
        mask[:, :2] = 0
    else:  # "noise": random sub-pixel jitter, many near-boundary tests
        wx = xx + rng.uniform(-0.7, 0.7, (H, W))
        wy = yy + rng.uniform(-0.7, 0.7, (H, W))
    warp = np.stack([wx, wy]).astype(np.float32)
    rgb = rng.integers(0, 255, (3, H, W)).astype(np.float32)
    return warp, rgb, mask


KINDS = ("rigid", "wavy", "fold", "edge", "noise")


@pytest.mark.parametrize("kind", KINDS)
def test_rasterize_equal(kind):
    warp, rgb, mask = _warp_case(kind)
    jr, jm = JR.rasterize(jnp.asarray(warp), jnp.asarray(rgb), jnp.asarray(mask))
    tr, tm = TR.rasterize(torch.as_tensor(warp), torch.as_tensor(rgb),
                          torch.as_tensor(mask))
    assert (np.asarray(jm) > 0).sum() > 50
    np.testing.assert_array_equal(tm.numpy().astype(np.uint8),
                                  np.asarray(jm).astype(np.uint8))
    np.testing.assert_array_equal(tr.numpy().astype(np.uint8),
                                  np.asarray(jr).astype(np.uint8))


@pytest.mark.parametrize("combine", ["max", "min"])
@pytest.mark.parametrize("kind", ["wavy", "fold"])
def test_seed_map_equal(kind, combine):
    warp, _, mask = _warp_case(kind, seed=1)
    m = mask == 0
    drawable = np.zeros_like(m)
    drawable[:-1, :-1] = m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]
    js = JR._seed_map(jnp.asarray(warp), jnp.asarray(drawable), 3, combine)
    ts = TR._seed_map(torch.as_tensor(warp), torch.as_tensor(drawable), 3,
                      combine)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


def test_lk_accept_equal():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (8, 500)).astype(np.float32)
    pts[:6, :10] = 0.0  # degenerate triangles: ssum == 0
    jo = JR._lk_accept(*(jnp.asarray(p) for p in pts))
    to = TR._lk_accept(*(torch.as_tensor(p) for p in pts))
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    for j, t in zip(jo[1:], to[1:]):
        ok = np.asarray(jo[0])
        np.testing.assert_array_equal(t.numpy()[ok], np.asarray(j)[ok])


def test_rasterize_flow_equal():
    warp, rgb, mask = _warp_case("wavy", seed=3)
    H, W = mask.shape
    flow = warp - np.stack(np.meshgrid(np.arange(W), np.arange(H))).astype(
        np.float32)
    np.testing.assert_array_equal(
        TR.make_warp(torch.as_tensor(flow)).numpy(),
        np.asarray(JR.make_warp(jnp.asarray(flow))))
    jr, jm = JR.rasterize_flow(jnp.asarray(flow), jnp.asarray(rgb),
                               jnp.asarray(mask))
    tr, tm = TR.rasterize_flow(torch.as_tensor(flow), torch.as_tensor(rgb),
                               torch.as_tensor(mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
