"""The traffic generator and the codecs: the same seed gives the same
inputs, another seed other pixels but the same work, and the JPEG pixels
the reference takes are the ones a libjpeg-exact decoder reads."""

import json
import os
import os.path as osp

import numpy as np
import pytest

from benchmark import harness, images, traffic
from benchmark.entries import davis480, sintel1024
from benchmark.tests import cut

WL = osp.join(harness.ROOT, "benchmark", "workloads")


def _wl(cell):
    with open(osp.join(WL, cell + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["davis480.seq24", "sintel1024.passes"])
def test_scene_deterministic_per_seed(cell):
    wl = _wl(cell)
    t = traffic.Scene(wl, 0).n - 1
    a = traffic.Scene(wl, 2 ** 31 + 5).frame(t)
    b = traffic.Scene(wl, 2 ** 31 + 5).frame(t)
    c = traffic.Scene(wl, 7).frame(t)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert np.array_equal(a[1], c[1])  # the seed changes pixels, not work


def test_davis_sizes_one_a_sequence():
    wl = _wl("davis480.seq24")
    sc = traffic.Scene(wl, 0)
    assert sc.n == 30 and sum(n - 1 for n in sc.lengths) == 24
    obj1, obj2 = wl["objects"]
    for k in range(len(sc.lengths)):
        t = sum(sc.lengths[:k])
        assert sc.geometry(obj1, t)[2:4] == tuple(map(float, obj1["sizes"][k]))
        assert sc.geometry(obj1, t + sc.lengths[k] - 1)[2:4] == \
            sc.geometry(obj1, t)[2:4]
        assert sc.geometry(obj2, t)[2:4] == traffic.size_at(obj2, k)


def test_objects_stay_inside_the_frame():
    for cell in ("davis480.seq24", "sintel1024.passes"):
        wl = _wl(cell)
        sc = traffic.Scene(wl, 1)
        for t in range(sc.n):
            _, mask = sc.frame(t)
            for obj in wl["objects"]:
                ys, xs = np.nonzero(mask == obj["id"])
                assert ys.size > 100
                assert ys.min() > 0 and xs.min() > 0
                assert ys.max() < wl["height"] - 1
                assert xs.max() < wl["width"] - 1


def test_jpeg_pixels_equal_the_programs_decoder(tmp_path):
    from arap_flow_tpu_torch.io.image import load_rgb

    wl = _wl("davis480.seq24")
    img, _ = traffic.Scene(wl, 3).frame(5)
    for shape in ((480, 854), (37, 53)):
        sub = np.ascontiguousarray(img[:shape[0], :shape[1]])
        data, coefs = images.jpeg_encode(sub, 95)
        path = tmp_path / "f.jpg"
        path.write_bytes(data)
        assert np.array_equal(load_rgb(str(path)), images.jpeg_pixels(coefs))


def test_png_round_trips():
    from arap_flow_tpu_torch.io.image import png_encode

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    gray = rgb[..., 1].copy()
    for a in (rgb, gray):
        assert np.array_equal(images.png_decode(images.png_encode(a)), a)
        assert np.array_equal(images.png_decode(png_encode(a)), a)


def test_prepare_writes_the_same_files_for_a_seed(tmp_path):
    for mod, cell in ((davis480, "davis480.seq24"),
                      (sintel1024, "sintel1024.passes")):
        _, _, cfg, wl = harness.load_cell(cell)
        wl = {**wl, **cut.CELLS[cell]}
        trees = []
        for k in range(2):
            work = tmp_path / f"{cell}{k}"
            os.makedirs(work)
            mod.prepare(cfg, wl, 99, str(work), "cpu")
            trees.append({osp.relpath(osp.join(r, f), work):
                          open(osp.join(r, f), "rb").read()
                          for r, _, fs in os.walk(work) for f in fs})
        assert trees[0] == trees[1] and trees[0]


def test_constraints_lie_on_their_objects():
    wl = {**_wl("sintel1024.passes")}
    sc = traffic.Scene(wl, 4)
    _, mask = sc.frame(0)
    cons = traffic.constraint_grid(sc, 0, wl["constraint_step"],
                                   wl["constraint_inner"])
    assert len(cons) > 500
    assert (mask[cons[:, 1], cons[:, 0]] != 0).all()
    d = np.hypot(cons[:, 2] - cons[:, 0], cons[:, 3] - cons[:, 1])
    assert d.max() < 20
