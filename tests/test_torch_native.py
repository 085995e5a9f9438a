"""The port's native host library (g++, built on first use) against the JAX
package: the exact splat, the .flo codec and the asynchronous writer.

- The C++ splat (``native.runtime.rasterize_warp``) and the port's numpy
  copy (``native.host_raster.rasterize_warp_exact``) are bitwise equal to
  the JAX package's ``native/host_raster.rasterize_warp_exact`` on
  numpy-seeded warps: a rotation, folds (backfacing triangles),
  out-of-frame corners, jitter with overlaps and a non-finite corner.
- ``ArapDeformer(raster="host")`` gives the JAX host-raster deformer's
  products (flow within the solver tolerance of test_torch_slice.py,
  raster bitwise equal on the port's own flow).
- The .flo writer and reader are byte-equal to the JAX ``io/flo``;
  ``AsyncWriter`` drains, and counts writes that fail.
- The library's build is keyed by its source and flags, and a failed
  build raises.
"""

import os

import numpy as np
import pytest

from arap_flow_tpu.io import flo as JF
from arap_flow_tpu.native.host_raster import rasterize_warp_exact as j_raster
from arap_flow_tpu.native.host_raster import warp_from_flow as j_warp_from_flow
from arap_flow_tpu_torch import _build
from arap_flow_tpu_torch.native import host_raster as TH
from arap_flow_tpu_torch.native import runtime as TR

H, W = 40, 56


def _rgb_mask(seed, box=(6, 34, 8, 48)):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    mask = np.full((H, W), 255, np.uint8)
    y0, y1, x0, x1 = box
    mask[y0:y1, x0:x1] = 0
    return rgb, mask


def _warp(kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if kind == "rotation":
        th, cy, cx = 0.3, H / 2, W / 2
        u = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx + 4 - xx
        v = np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy - 2 - yy
    elif kind == "fold":
        # x' = x + 9 sin(x / 3) folds the grid over itself: backfacing and
        # overlapping triangles
        u = 9 * np.sin(xx / 3) + 0 * yy
        v = 3 * np.cos(yy / 4) + 0 * xx
    elif kind == "out_of_frame":
        u = np.full((H, W), -30.5, np.float32) + xx * 0.8
        v = np.full((H, W), 25.25, np.float32) - yy * 0.1
    elif kind == "jitter":
        u = rng.normal(0, 1.6, (H, W))
        v = rng.normal(0, 1.6, (H, W))
    else:  # non-finite corners among a smooth warp
        u = 2 + np.sin(yy / 5) + 0 * xx
        v = -1 + np.cos(xx / 7) + 0 * yy
        u[10, 20] = np.nan
        v[22, 30] = np.inf
    return np.stack([u, v], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["rotation", "fold", "out_of_frame",
                                  "jitter", "non_finite"])
def test_splat_bitwise_equal_to_jax(kind):
    rgb, mask = _rgb_mask(1)
    flow = _warp(kind, 2)
    warp = j_warp_from_flow(flow)
    np.testing.assert_array_equal(TH.warp_from_flow(flow), warp)
    ref_rgb, ref_mask = j_raster(warp, rgb, mask)
    for got_rgb, got_mask in (TR.rasterize_warp(warp, rgb, mask),
                              TH.rasterize_warp_exact(warp, rgb, mask)):
        np.testing.assert_array_equal(got_mask, ref_mask)
        np.testing.assert_array_equal(got_rgb, ref_rgb)
    if kind != "out_of_frame":
        assert ref_mask.sum() > 0


def test_host_raster_deformer_matches_jax():
    """raster="host" on the crop path and the full-frame path: the flow is
    the device deformer's, and the products are the exact splat of it."""
    from arap_flow_tpu.models import arap as JA
    from arap_flow_tpu.ops.solver import SolverConfig as JConfig
    from arap_flow_tpu_torch.models import arap as TA
    from arap_flow_tpu_torch.ops.solver import SolverConfig as TConfig

    short = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)
    rgb, mask = _rgb_mask(3, box=(10, 30, 12, 44))
    ys, xs = np.mgrid[12:30:4, 14:44:4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 2,
                     ys.ravel() + 1], 1).astype(np.int32)
    for crop in (True, False):
        t = TA.ArapDeformer(TConfig(**short), crop=crop, raster="host",
                            device="cpu").deform(rgb, mask, cons)
        j = JA.ArapDeformer(JConfig(**short, backend="xla"), crop=crop,
                            raster="host").deform(rgb, mask, cons)
        assert np.abs(t.flow - j.flow).max() < 0.05
        ref_rgb, ref_mask = j_raster(j_warp_from_flow(t.flow), rgb, mask)
        np.testing.assert_array_equal(t.warped_mask, ref_mask)
        np.testing.assert_array_equal(t.warped_rgb, ref_rgb)
        assert (t.warped_mask == j.warped_mask).mean() > 0.99
        assert t.warped_mask.sum() > 0


def test_flo_codec_byte_equal_to_jax(tmp_path):
    uv = np.random.default_rng(4).standard_normal((21, 17, 2)).astype(
        np.float32)
    TR.flo_write(tmp_path / "t.flo", uv)
    JF.flow_write(tmp_path / "j.flo", uv)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    u, v = TR.flo_read(tmp_path / "j.flo")
    ju, jv = JF.flow_read(tmp_path / "t.flo")
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)
    (tmp_path / "bad.flo").write_bytes(b"nope" + bytes(8))
    with pytest.raises(OSError):
        TR.flo_read(tmp_path / "bad.flo")
    with pytest.raises(OSError):
        TR.flo_write(tmp_path / "missing" / "x.flo", uv)


def test_async_writer_drains_and_counts_errors(tmp_path):
    rng = np.random.default_rng(5)
    uvs = [rng.standard_normal((10, 12, 2)).astype(np.float32)
           for _ in range(8)]
    refs = [JF.flow_encode(uv) for uv in uvs]
    with TR.AsyncWriter(threads=3) as w:
        for i, uv in enumerate(uvs):
            w.submit_flo(tmp_path / f"{i}.flo", uv)
            w.submit_bytes(tmp_path / f"{i}.bin", b"x" * 100 + bytes([i]))
        # a directory that does not exist: two failed writes
        w.submit_flo(tmp_path / "missing" / "a.flo", uvs[0])
        w.submit_bytes(tmp_path / "missing" / "b.bin", b"data")
        w.drain()
        assert w.errors() == 2
    assert w.errors() == 2  # readable after close
    for i in range(8):
        assert (tmp_path / f"{i}.flo").read_bytes() == refs[i]
        assert (tmp_path / f"{i}.bin").read_bytes() == b"x" * 100 + bytes([i])
    with TR.AsyncWriter(threads=1) as w2:  # a new writer counts afresh
        w2.submit_bytes(tmp_path / "c.bin", b"c")
        with pytest.raises(RuntimeError, match="already open"):
            TR.AsyncWriter(threads=1)
    assert w2.errors() == 0 and (tmp_path / "c.bin").read_bytes() == b"c"


def test_writer_copies_the_submitted_field(tmp_path):
    """The flo payload is copied at submit: changing the array afterwards
    does not change the file."""
    uv = np.random.default_rng(6).standard_normal((9, 7, 2)).astype(np.float32)
    ref = JF.flow_encode(uv)
    with TR.AsyncWriter(threads=1) as w:
        w.submit_flo(tmp_path / "a.flo", uv)
        uv[:] = 7.0
    assert (tmp_path / "a.flo").read_bytes() == ref


def test_build_is_keyed_and_failures_raise(monkeypatch, tmp_path):
    lib, _ = _build.build_native()
    assert os.path.exists(lib) and lib == _build.native_lib_path()
    assert _build.build_native() == (lib, 0.0)  # built: nothing to do
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "GXX_FLAGS", ("-O3", "-DNOT_A_FLAG=(", "-x",
                                              "c++", "-std=c++17", "-shared",
                                              "-fPIC"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", str(bad))
    assert _build.native_lib_path() != lib
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        _build.build_native()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_native()
