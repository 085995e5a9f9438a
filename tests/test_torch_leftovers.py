"""The port's small leftovers against the JAX package: the rasterizer's
candidate options (window, dilate, anchor, min_rect) on
tests/test_rasterize.py's controlled cases, compose_segments and
add_background, the Sintel formats and .imagedump.

Tolerances: the rasterizers' masks exactly, and their colours exactly
but where a colour sits on a truncation boundary: both truncate the same
float32 expressions, and on the translate case (flow 5.2, 3.7) 4 of 15,360
colour values come out 1 apart with or without the options. There the
exact colour (rational arithmetic on the float32 warp) lies within 2e-5
below an integer, and float32 rounding decides the truncation: XLA's
evaluation (a fused multiply-add sum reproduces it on 3 of the 4) and the
port's plain one land on opposite sides, the exact floor siding with JAX
on 3 and with the port on 1; each side is off the exact floor on about 30
values of the image. So colours are held equal on >= 99.9% of values and
within 1 elsewhere. Everything else exactly: the
raw formats byte-identical, the PNG-coded disparity and segmentation
files the same pixels (the two packages' PNG encoders compress
differently), and each package reads the other's files to the same
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu import io as JIO
from arap_flow_tpu.io import imagedump as JDump
from arap_flow_tpu.ops import compose as JC
from arap_flow_tpu.ops import rasterize as JR
from arap_flow_tpu_torch import io as TIO
from arap_flow_tpu_torch.io import imagedump as TDump
from arap_flow_tpu_torch.ops import compose as TC
from arap_flow_tpu_torch.ops import rasterize as TR

torch.set_num_threads(2)


def _case(case: str, H=64, W=80):
    """tests/test_rasterize.py's controlled cases: (flow (2, H, W), rgb
    (H, W, 3), mask)."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    f = np.zeros((2, H, W), np.float32)
    if case == "translate":
        f[0], f[1] = 5.2, 3.7
    elif case == "segment":
        mask = np.full((H, W), 255, np.uint8)
        mask[20:40, 10:30] = 0
        f[0], f[1] = 25.0, 10.0
    else:
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        cy, cx, th = H / 2, W / 2, 0.4
        xr = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx
        yr = np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy
        f = np.stack([xr - xx, yr - yy]).astype(np.float32)
    return f, rgb, mask


@pytest.mark.parametrize("case, kw", [
    ("segment", dict(window=3)),
    ("rotate", dict(window=4, anchor=1)),
    ("rotate", dict(window=3, min_rect=(-1, 1, -1, 0))),
    ("translate", dict(dilate=1, min_rect=None)),
])
def test_rasterize_options_equal_jax(case, kw):
    f, rgb, mask = _case(case)
    jr, jm = (np.asarray(a) for a in JR.rasterize_flow(
        jnp.asarray(f), jnp.asarray(rgb.transpose(2, 0, 1), jnp.float32),
        jnp.asarray(mask), **kw))
    tr, tm = TR.rasterize_flow(
        torch.tensor(f), torch.tensor(rgb.transpose(2, 0, 1),
                                      dtype=torch.float32),
        torch.tensor(mask), **kw)
    assert (jm > 0).mean() > 0.05
    np.testing.assert_array_equal(tm.numpy(), jm)
    d = np.abs(tr.numpy() - jr)
    assert (d == 0).mean() >= 0.999 and d.max() <= 1


def test_rasterize_defaults_are_the_calibrated_rects():
    """No option: the dual-seed rects, the same products as before the
    options existed (window None, dilate 3, min_rect "default")."""
    f, rgb, mask = _case("rotate")
    args = (torch.tensor(f), torch.tensor(rgb.transpose(2, 0, 1),
                                          dtype=torch.float32),
            torch.tensor(mask))
    plain = TR.rasterize_flow(*args)
    spelled = TR.rasterize_flow(*args, window=None, dilate=3, anchor=None,
                                min_rect=(-1, 1, -1, 0))
    for a, b in zip(plain, spelled):
        assert torch.equal(a, b)
    assert TR._rects(None, None, "default") == ((-2, 0, -2, 1), (-1, 1, -1, 0))
    assert TR._rects(4, None, "default") == ((-2, 1, -2, 1), None)
    assert TR._rects(1, None, (0, 1, 0, 1)) == ((0, 0, 0, 0), (0, 1, 0, 1))


def test_anchor_without_window_rejected():
    z = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="anchor"):
        TR.rasterize(z, torch.zeros((3, 8, 8)), torch.zeros((8, 8)), anchor=2)
    with pytest.raises(ValueError, match="anchor"):
        JR.rasterize(jnp.zeros((2, 8, 8)), jnp.zeros((3, 8, 8)),
                     jnp.zeros((8, 8)), anchor=2)


def test_compose_segments_equal_jax():
    rng = np.random.default_rng(3)
    S, H, W = 4, 12, 16
    flows = rng.normal(size=(S, 2, H, W)).astype(np.float32)
    rgbs = rng.uniform(0, 255, (S, 3, H, W)).astype(np.float32)
    masks = (rng.uniform(size=(S, H, W)) > 0.6).astype(np.float32) * 255
    want = [np.asarray(a) for a in JC.compose_segments(
        jnp.asarray(flows), jnp.asarray(rgbs), jnp.asarray(masks))]
    got = TC.compose_segments(torch.tensor(flows), torch.tensor(rgbs),
                              torch.tensor(masks))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the last segment that covers a pixel wins it
    last = masks[3] != 0
    np.testing.assert_array_equal(got[0].numpy()[:, last], flows[3][:, last])


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_add_background_equal_jax(layout):
    rng = np.random.default_rng(4)
    shape = (3, 10, 14) if layout == "chw" else (10, 14, 3)
    rgb, bg = (rng.uniform(0, 255, shape).astype(np.float32) for _ in "ab")
    mask = np.where(rng.uniform(size=(10, 14)) > 0.5, 255.0, 0.0).astype(
        np.float32)
    for bgval in (0.0, 255.0):
        want = np.asarray(JC.add_background(jnp.asarray(rgb), jnp.asarray(mask),
                                            jnp.asarray(bg), bgval))
        got = TC.add_background(torch.tensor(rgb), torch.tensor(mask),
                                torch.tensor(bg), bgval)
        np.testing.assert_array_equal(got.numpy(), want)


def _bytes(p):
    with open(p, "rb") as f:
        return f.read()


def test_sintel_raw_formats_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    depth = rng.uniform(0, 50, (9, 13)).astype(np.float32)
    M, N = rng.normal(size=(3, 3)), rng.normal(size=(3, 4))
    for pkg, name in ((JIO, "j"), (TIO, "t")):
        pkg.depth_write(tmp_path / f"{name}.dpt", depth)
        pkg.cam_write(tmp_path / f"{name}.cam", M, N)
    for ext in ("dpt", "cam"):
        assert _bytes(tmp_path / f"t.{ext}") == _bytes(tmp_path / f"j.{ext}")
    np.testing.assert_array_equal(TIO.depth_read(tmp_path / "j.dpt"), depth)
    for a, b in zip(TIO.cam_read(tmp_path / "j.cam"), (M, N)):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.dpt").write_bytes(b"\0" * 16)
    for fn in (TIO.depth_read, TIO.cam_read):
        with pytest.raises(ValueError, match="wrong tag"):
            fn(tmp_path / "bad.dpt")


@pytest.mark.parametrize("bitdepth", [16, 24])
def test_sintel_png_formats_same_pixels(tmp_path, bitdepth):
    rng = np.random.default_rng(6)
    disp = rng.uniform(-10, 1100, (11, 17))
    seg = rng.integers(0, 256 ** 3, (11, 17))
    for pkg, name in ((JIO, "j"), (TIO, "t")):
        pkg.disparity_write(tmp_path / f"{name}_d.png", disp, bitdepth)
        pkg.segmentation_write(tmp_path / f"{name}_s.png", seg)
    for kind, read in (("d", "disparity_read"), ("s", "segmentation_read")):
        want = getattr(JIO, read)(tmp_path / f"j_{kind}.png")
        for pkg in (JIO, TIO):  # each package reads the other's file
            np.testing.assert_array_equal(
                getattr(pkg, read)(tmp_path / f"t_{kind}.png"), want)
        np.testing.assert_array_equal(
            getattr(TIO, read)(tmp_path / f"j_{kind}.png"), want)
    np.testing.assert_array_equal(TIO.segmentation_read(tmp_path / "t_s.png"),
                                  seg)


def test_imagedump_byte_identical(tmp_path):
    rng = np.random.default_rng(7)
    for shape in ((5, 7), (5, 7, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        JDump.imagedump_write(tmp_path / "j.imagedump", img)
        TIO.imagedump_write(tmp_path / "t.imagedump", img)
        assert _bytes(tmp_path / "t.imagedump") == _bytes(
            tmp_path / "j.imagedump")
        got = TDump.imagedump_read(tmp_path / "j.imagedump")
        np.testing.assert_array_equal(got, img.reshape(5, 7, -1))
    raw = bytearray(_bytes(tmp_path / "t.imagedump"))
    raw[12] = 1  # datatype 1: reserved
    (tmp_path / "bad.imagedump").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="datatype"):
        TDump.imagedump_read(tmp_path / "bad.imagedump")
