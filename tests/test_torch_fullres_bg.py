"""``para_gen --size W H --bg_dir DIR --seed S`` on full-resolution JPEG
frames against the benchmark's plain reference (``benchmark/reference/
fullres.py``), on seeded inputs at small sizes: the port's PIL-exact
resizes, the native LANCZOS's output windows against the crop of the
whole resize (and of PIL's, where PIL imports), the background fit's
bytes and random stream against an upscale of the whole background, the
``io.resize.RESAMPLED`` share, its JPEG decode at a height of 8 mod 16
and an odd width, its background pool's draws, a pair's input frame and
background-composited warped frame on a fixed warp, and the stages
``preprocess resize`` and ``background draw`` of a batched run.
"""

import json
import os
import os.path as osp
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io.image import load_rgb
from arap_flow_tpu_torch.io import resize as RS
from arap_flow_tpu_torch.io.resize import (resize_lanczos,
                                           resize_lanczos_window,
                                           resize_nearest)
from arap_flow_tpu_torch.ops.rasterize import rasterize
from arap_flow_tpu_torch.pipeline import para_gen as TP
from arap_flow_tpu_torch.utils import profiling as P
from benchmark import images
from benchmark.reference import fullres as R

torch.set_num_threads(2)

# (H, W) -> (w, h): downscales, upscales, one axis alone, odd sizes
RESIZES = [((108, 192), (49, 28)), ((1080 // 8, 1920 // 8), (109, 61)),
           ((37, 53), (71, 90)), ((50, 61), (50, 33)), ((45, 77), (13, 9)),
           ((31, 17), (31, 64)), ((29, 43), (97, 57)), ((64, 48), (150, 23))]


@pytest.mark.parametrize("hw,size", RESIZES)
def test_resizes_are_the_references_bitwise(hw, size):
    rng = np.random.default_rng(hw[0] * 1000 + size[0])
    im = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resize_lanczos(im, size),
                                  R.resize_lanczos(im, size))
    mk = rng.integers(0, 5, hw).astype(np.uint8)
    np.testing.assert_array_equal(resize_nearest(mk, size),
                                  R.resize_nearest(mk, size))


# (H, W) -> (w, h): upscales at r near 1 (one axis unchanged), 1.5 and 2,
# and davis1080's frame downscale at 1/8 of its size
WINDOW_RESIZES = [((60, 100), (101, 60)), ((60, 100), (150, 90)),
                  ((61, 99), (197, 121)), ((1080 // 8, 1920 // 8), (109, 61))]


def _window(kind, h, w):
    """(top, left, height, width) of a window of an (h, w) resize."""
    return {"top": (0, w // 3, h // 4, w // 3),
            "bottom": (h - h // 4, w // 5, h // 4, w // 2),
            "left": (h // 3, 0, h // 3, w // 4),
            "right": (h // 5, w - w // 4, h // 2, w // 4),
            "pixel": (h // 2, w // 2, 1, 1),
            "whole": (0, 0, h, w)}[kind]


@pytest.mark.parametrize("kind", ["top", "bottom", "left", "right", "pixel",
                                  "whole"])
@pytest.mark.parametrize("hw,size", WINDOW_RESIZES)
def test_window_is_the_crop_of_the_whole_resize(hw, size, kind):
    rng = np.random.default_rng(hw[0] * 1000 + size[0])
    t, l, hh, ww = _window(kind, size[1], size[0])
    for im in (rng.integers(0, 256, (*hw, 3)).astype(np.uint8),
               rng.integers(0, 256, (*hw, 4)).astype(np.uint8),
               rng.integers(0, 256, hw).astype(np.uint8)):
        got = resize_lanczos_window(im, size, t, l, hh, ww)
        assert got.shape == (hh, ww, *im.shape[2:])
        np.testing.assert_array_equal(
            got, resize_lanczos(im, size)[t:t + hh, l:l + ww])


@pytest.mark.parametrize("kind", ["top", "bottom", "left", "right", "pixel"])
@pytest.mark.parametrize("hw,size", WINDOW_RESIZES)
def test_window_is_the_crop_of_pils_resize(hw, size, kind):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(hw[1] * 1000 + size[1])
    t, l, hh, ww = _window(kind, size[1], size[0])
    rgb = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    cmyk = rng.integers(0, 256, (*hw, 4)).astype(np.uint8)  # no alpha
    for im, pil in ((rgb, Image.fromarray(rgb)),
                    (cmyk, Image.frombytes("CMYK", hw[::-1], cmyk.tobytes())),
                    (rgb[..., 1], Image.fromarray(rgb[..., 1]))):
        want = np.asarray(pil.resize(size, Image.LANCZOS))
        np.testing.assert_array_equal(
            resize_lanczos_window(im, size, t, l, hh, ww),
            want[t:t + hh, l:l + ww])


@pytest.mark.parametrize("window", [(-1, 0, 2, 2), (0, -1, 2, 2),
                                    (0, 0, 0, 2), (0, 0, 2, 0),
                                    (59, 0, 2, 2), (0, 100, 1, 2)])
def test_a_window_outside_the_resize_raises(window):
    im = np.zeros((30, 50, 3), np.uint8)
    with pytest.raises(ValueError):
        resize_lanczos_window(im, (101, 60), *window)


def _fit_whole(rng, bg, shape):
    """The background fit as an upscale of the whole background, then the
    crop: the same draws in the same order."""
    imh, imw = shape[:2]
    bgh, bgw = bg.shape[:2]
    r = rng.uniform(1, 2) * max(float(max(bgh, imh)) / bgh,
                                float(max(bgw, imw)) / bgw)
    up = resize_lanczos(bg, (int(bgw * r), int(bgh * r)))
    sy = rng.integers(0, up.shape[0] - imh + 1)
    sx = rng.integers(0, up.shape[1] - imw + 1)
    return up[sy:sy + imh, sx:sx + imw, :3]


@pytest.mark.parametrize("seed", [7, 2024, 3000000001, 2**31 + 5])
def test_fit_is_the_crop_of_the_whole_upscale(seed):
    src = np.random.default_rng(seed)
    pool = TP.BackgroundPool(None, np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    for bg_hw, frame_hw in (((90, 160), (40, 70)), ((50, 44), (48, 60)),
                            ((135, 240), (60, 107))):
        bg = src.integers(0, 256, (*bg_hw, 3)).astype(np.uint8)
        np.testing.assert_array_equal(pool.fit(bg, (*frame_hw, 3)),
                                      _fit_whole(rng, bg, (*frame_hw, 3)))
    # the stream goes on where the whole upscale's leaves it
    assert pool.rng.integers(0, 2**62) == rng.integers(0, 2**62)


def _share(before):
    c = RS.RESAMPLED
    return ((c["computed"] - before.get("computed", 0))
            / (c["full"] - before.get("full", 0)))


@pytest.mark.parametrize("stage", ["background", "frame"])
def test_resampled_reads_the_share_of_the_full_work(stage, tmp_path):
    before = dict(RS.RESAMPLED)
    if stage == "background":
        _write_backgrounds(str(tmp_path), [(90, 160)])
        pool = TP.BackgroundPool(str(tmp_path), np.random.default_rng(3))
        assert pool.draw((40, 70, 3)).shape == (40, 70, 3)
        assert 0 < _share(before) < 0.2
    else:
        TP.scale_rotate(*_scene(0), SIZE)
        assert _share(before) == 1.0


def test_resampled_loses_no_count_across_threads():
    """More threads than cores resizing at once, switching every
    microsecond: every window is still the whole resize's crop, and the
    counter holds every pixel."""
    im = np.random.default_rng(8).integers(0, 256, (30, 50, 3)).astype(
        np.uint8)
    whole = resize_lanczos(im, (71, 43))
    n_threads, calls = 4 * (os.cpu_count() or 1), 40
    before = dict(RS.RESAMPLED)

    def work(k):
        for c in range(calls):
            t, l = (k + c) % 40, (3 * k + c) % 60
            got = resize_lanczos_window(im, (71, 43), t, l, 3, 11)
            if not np.array_equal(got, whole[t:t + 3, l:l + 11]):
                return False
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n_threads) as ex:
            futures = [ex.submit(work, k) for k in range(n_threads)]
            assert all(f.result(timeout=120) for f in futures)
    finally:
        sys.setswitchinterval(interval)
    n = n_threads * calls
    assert RS.RESAMPLED["computed"] - before.get("computed", 0) == n * 33
    assert RS.RESAMPLED["full"] - before.get("full", 0) == n * 71 * 43


@pytest.mark.parametrize("hw", [(24, 37), (40, 63), (56, 17), (72, 101)])
def test_jpeg_decode_at_a_half_mcu_row_and_odd_width(hw, tmp_path):
    """Heights of 8 mod 16 leave half an MCU row at the bottom, where the
    chroma's fancy upsampling reads its last row twice."""
    assert hw[0] % 16 == 8 and hw[1] % 2 == 1
    rng = np.random.default_rng(hw[1])
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    img = np.stack([(yy * 7 + xx * 3) % 256, (xx * 11) % 256,
                    rng.integers(0, 256, hw)], -1).astype(np.uint8)
    data, coefs = images.jpeg_encode(img, 95)
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(load_rgb(str(path)),
                                  images.jpeg_pixels(coefs))


def _write_backgrounds(d, hws, seed=11):
    """JPEG backgrounds in pool order; returns their decoded pixels."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    pixels = []
    for i, hw in enumerate(hws):
        data, coefs = images.jpeg_encode(
            rng.integers(0, 256, (*hw, 3)).astype(np.uint8), 95)
        with open(osp.join(d, f"bg{i:03d}.jpg"), "wb") as f:
            f.write(data)
        pixels.append(images.jpeg_pixels(coefs))
    return pixels


def test_background_pool_draws_the_reference_replay(tmp_path):
    hws = [(40, 72), (56, 50), (24, 100)]
    pixels = _write_backgrounds(str(tmp_path), hws)
    frame_hw = (30, 48)
    pool = TP.BackgroundPool(str(tmp_path), np.random.default_rng(2024))
    draws = R.background_draws(7, hws, frame_hw, 2024)
    assert sorted(d[0] for d in draws[:3]) == [0, 1, 2]  # without replacement
    for d in draws:
        got = pool.draw((*frame_hw, 3))
        np.testing.assert_array_equal(got, R.fit_background(pixels[d[0]], d,
                                                            frame_hw))


SRC = (168, 312)  # source frames (H, W): 8 mod 16 rows, resized to SIZE
SIZE = (136, 72)  # --size (w, h); the crop buckets are 128 wide at least


def _scene(t, seed=5):
    """A frame and its mask: two textured boxes moving over a dark
    background."""
    H, W = SRC
    rng = np.random.default_rng(seed)
    tex = np.kron(rng.uniform(60, 255, (H // 4 + 2, W // 4 + 2, 3)),
                  np.ones((4, 4, 1)))[:H, :W].astype(np.uint8)
    img, mask = (tex[::-1, ::-1] // 4).copy(), np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    for k, (y0, x0, dy, dx) in enumerate(((20, 24, 4, 6), (80, 150, 6, -4))):
        y, x = y0 + dy * t, x0 + dx * t
        ob = (yy >= y) & (yy < y + 50) & (xx >= x) & (xx < x + 74)
        img[ob] = tex[yy[ob] - dy * t, xx[ob] - dx * t]
        mask[ob] = k + 1
    return img, mask


def _tree(root, n_frames):
    """JPEG frames and PNG masks; returns [(frame pixels, mask)]."""
    for d in ("orgRGB/seq0", "orgMasks/seq0"):
        os.makedirs(osp.join(root, d))
    out = []
    for t in range(n_frames):
        img, mask = _scene(t)
        data, coefs = images.jpeg_encode(img, 95)
        with open(osp.join(root, "orgRGB/seq0", f"{t:05d}.jpg"), "wb") as f:
            f.write(data)
        with open(osp.join(root, "orgMasks/seq0", f"{t:05d}.png"), "wb") as f:
            f.write(images.png_encode(mask))
        out.append((images.jpeg_pixels(coefs), mask))
    return out


def _flags(tmp_path, *extra):
    return TP.parse_args(["--input", str(tmp_path / "in"), "--output",
                          str(tmp_path / "out"), "--multseg", "--size",
                          str(SIZE[0]), str(SIZE[1]), "--bg_dir",
                          str(tmp_path / "bg"), "--seed", "99", "--device",
                          "cpu", *extra])


def test_prep_and_finish_are_the_references_on_a_fixed_warp(tmp_path):
    frames = _tree(str(tmp_path / "in"), 2)
    bg_hws = [(90, 150), (120, 140)]
    bgs = _write_backgrounds(str(tmp_path / "bg"), bg_hws)
    flags = _flags(tmp_path)
    (p,) = TP.scan_pairs(flags)
    frame_hw = SIZE[::-1]
    # the reference: both frames resized, the first draw replayed
    im1, mk1 = R.scale_rotate(*frames[0], SIZE)
    (draw,) = R.background_draws(1, bg_hws, frame_hw, 99)
    bg = R.fit_background(bgs[draw[0]], draw, frame_hw)
    inp = R.add_bg(im1, mk1, bg)
    # matches of each object one pixel right, as the matcher would give
    ys, xs = np.nonzero(mk1[2:-2, 2:-2])
    matches = np.stack([xs + 2, ys + 2, xs + 3, ys + 2], 1).astype(np.int32)
    work = TP.prep_pair(flags, p, TP.BackgroundPool(
        flags.bg_dir, np.random.default_rng(99)), prematched=matches)
    np.testing.assert_array_equal(work.out1, inp)
    np.testing.assert_array_equal(work.bgim, bg)
    H, W = mk1.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    warp = torch.stack([gx + 1.25, gy + 0.5])  # a fixed warp, sub-pixel
    results, segments = [], []
    for s, arap_mask, _ in work.segments:
        wr, wm = rasterize(warp, torch.as_tensor(
            work.out1.transpose(2, 0, 1).astype(np.float32)),
            torch.as_tensor(arap_mask))
        results.append(SimpleNamespace(
            flow=np.zeros((H, W, 2), np.float32),
            warped_rgb=wr.to(torch.uint8).numpy().transpose(1, 2, 0),
            warped_mask=wm.to(torch.uint8).numpy()))
        segments.append((s, np.where(mk1 == s, 0, 255).astype(np.uint8),
                         warp))
    assert [s for s, _, _ in segments] == [1, 2]
    TP.finish_pair(work, results)
    want = R.compose(inp, bg, segments, "cpu")
    with open(p.rgb1_gen, "rb") as f:
        np.testing.assert_array_equal(images.png_decode(f.read()), inp)
    with open(p.rgb2_gen, "rb") as f:
        np.testing.assert_array_equal(images.png_decode(f.read()),
                                      want["wrgb"])
    with open(p.msk2_gen, "rb") as f:
        np.testing.assert_array_equal(images.png_decode(f.read()),
                                      want["wmask"])
    assert (want["wmask"] == 0).any() and (want["wmask"] != 0).any()


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def test_batched_run_records_a_resize_a_frame_and_a_draw_a_pair(
        tmp_path, monkeypatch):
    _tree(str(tmp_path / "in"), 4)  # 3 pairs: chunks of 2 and 1
    _write_backgrounds(str(tmp_path / "bg"), [(90, 150), (120, 140)])
    trace = tmp_path / "spans"
    monkeypatch.setenv("ARAP_TRACE", str(trace))
    monkeypatch.setenv("ARAP_ASYNC_IO", "0")
    before = dict(P.TIMER.counts)
    lines = TP.main_pipeline(
        _flags(tmp_path, "--mode", "batched", "--narap", "1"),
        solver_cfg=TP.SolverConfig(num_anneal=1, gn_iters=1, max_pcg_iters=5,
                                   pcg_iters=5.0))
    c = _diff(dict(P.TIMER.counts), before)
    assert len(lines) == 3
    # one decode a pair, two frames resized in it; one draw a pair prepped
    assert c["decode+preprocess"] == 3 and c["preprocess resize"] == 6
    assert c["background+inputs-io"] == c["background draw"] == 3
    (name,) = os.listdir(trace)
    with open(trace / name) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span"]: e for e in xs}
    for stage, parent in (("preprocess resize", "decode+preprocess"),
                          ("background draw", "background+inputs-io")):
        spans = [e for e in xs if e["name"] == stage]
        assert len(spans) == c[stage]
        for e in spans:
            up = by_id[e["args"]["parent"]]
            assert up["name"] == parent and up["tid"] == e["tid"]
            assert up["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                            <= up["ts"] + up["dur"])
    draws = [e for e in xs if e["name"] == "background draw"]
    assert sorted(e["args"]["pair"] for e in draws) == [0, 1, 2]


def test_no_resize_and_no_pool_record_neither_stage(tmp_path):
    im, mk = _scene(0)
    before = dict(P.TIMER.counts)
    TP.scale_rotate(im, mk, None)
    TP.scale_rotate(im, mk, (SRC[1], SRC[0]))  # already that size
    assert TP.BackgroundPool(None, np.random.default_rng(0)).draw(
        im.shape) is None
    c = _diff(dict(P.TIMER.counts), before)
    assert "preprocess resize" not in c and "background draw" not in c
    TP.scale_rotate(im, mk, SIZE)
    assert _diff(dict(P.TIMER.counts), before) == {"preprocess resize": 1}
