"""The port's dmo_gen (pipeline/dmo_gen.py) against the JAX package's.

- ``texture_sequence``: with one texture substituted in both packages, the
  textured frames are bitwise JAX's (captured before the JPEG encoders,
  which differ: the port's is not libjpeg byte for byte); with the real
  textures, drawn by both packages from the same seed, the frames and the
  decoded .jpg files are JAX's within the texture tolerance (>= 99.9%
  equal, else within 1).
- ``replicate_texture_set``: both packages re-texture one set-0 tree from
  one set-k input tree (portrait, so the transpose runs): inpRGB bitwise;
  wRGB bitwise with the host splat and equal to JAX's device rasterizer
  with ``device``; Flow, inpMasks and wMasks linked from set 0.
- tests/test_dmo_gen.py's three scenarios on the port: the flow against the
  mask motion, two texture sets with a byte-identical Flow, and portrait
  masks, on the port's own runs; the dual-set run's set-0 Flow is also
  held to JAX's dmo_gen on the same masks and seed. The dual-set run is
  made in a subprocess where importing PIL, jax or arap_flow_tpu fails,
  beside a texture_gen run.

Every run is on the CPU, with tests/test_pipeline.py's short schedule and
the matcher on a 2×-pooled image (the full-size CPU search at radius 64
costs 13 s a pair).
"""

import functools
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from arap_flow_tpu.pipeline import dmo_gen as JD
from arap_flow_tpu_torch.io import flo
from arap_flow_tpu_torch.io.image import load_mask, load_rgb, save_image
from arap_flow_tpu_torch.ops.solver import SolverConfig
from arap_flow_tpu_torch.pipeline import dmo_gen as TD
from arap_flow_tpu_torch.pipeline import para_gen as TP

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
# tests/test_pipeline.py's CFG
CFG = dict(num_anneal=4, gn_iters=3, max_pcg_iters=120, pcg_iters=120.0)
H, W = 64, 80
DX, DY = 3, 2


def _make_masks(root, n_frames=3, h=H, w=W):
    """tests/test_dmo_gen.py's masks: a 28×32 box moving by (DX, DY)."""
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    for t in range(n_frames):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = 14 + DY * t, 10 + DX * t
        m[y0 : y0 + 28, x0 : x0 + 32] = 1
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), m)


@pytest.fixture
def pooled_matcher(monkeypatch):
    monkeypatch.setattr(TD, "PipelineFlags",
                        functools.partial(TP.PipelineFlags, match_downscale=2))


def _fake_texture(key_seed, H_, W_, *_):
    rng = np.random.default_rng(key_seed)
    return rng.integers(0, 256, (2 * H_, 2 * W_, 3)).astype(np.uint8)


def test_texture_sequence_frames_bitwise_jax(tmp_path, monkeypatch):
    masks = tmp_path / "masks"
    os.makedirs(masks / "orgMasks" / "seq0")
    yy, xx = np.mgrid[0:H, 0:W]
    paths = []
    for t in range(3):  # two objects, one leaving the frame at t = 2
        m = np.zeros((H, W), np.uint8)
        m[((yy - 20 - 2 * t) / 9) ** 2 + ((xx - 20 - 3 * t) / 12) ** 2 < 1] = 1
        if t < 2:
            m[40:56, 50 - 4 * t : 70 - 4 * t] = 3
        paths.append(str(masks / "orgMasks" / "seq0" / f"{t:05d}.png"))
        save_image(paths[-1], m)
    frames = {}
    for name, mod in (("jax", JD), ("port", TD)):
        monkeypatch.setattr(mod, "_texture_for", _fake_texture)
        monkeypatch.setattr(
            mod, "save_image",
            lambda p, a, _n=name: frames.setdefault(_n, []).append(
                (osp.basename(p), np.array(a))))
    JD.texture_sequence(paths, str(tmp_path / "j"), 7)
    TD.texture_sequence(paths, str(tmp_path / "t"), 7, device="cpu")
    assert len(frames["port"]) == 3
    for (jn, ja), (tn, ta) in zip(frames["jax"], frames["port"]):
        assert jn == tn and jn.endswith(".jpg")
        np.testing.assert_array_equal(ta, ja)


def _assert_uint8_close(a: np.ndarray, b: np.ndarray) -> None:
    """tests/test_torch_textures.py's gate: >= 99.9% equal, else within 1."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert a.shape == b.shape
    assert (d == 0).mean() >= 0.999, (d != 0).mean()
    assert d.max() <= 1


def test_texture_sequence_textures_match_jax(tmp_path, monkeypatch):
    """Both packages texture one sequence from one seed: JAX's textures."""
    paths = []
    os.makedirs(tmp_path / "orgMasks" / "seq0")
    for t in range(2):  # two objects over a textured background
        m = np.zeros((H, W), np.uint8)
        m[10 + 2 * t : 40 + 2 * t, 8 + 3 * t : 44 + 3 * t] = 1
        m[44:60, 50 - 4 * t : 74 - 4 * t] = 2
        paths.append(str(tmp_path / "orgMasks" / "seq0" / f"{t:05d}.png"))
        save_image(paths[-1], m)
    frames = {}
    for name, mod in (("jax", JD), ("port", TD)):
        monkeypatch.setattr(
            mod, "save_image",
            lambda p, a, _n=name, _s=mod.save_image: (
                frames.setdefault(_n, []).append(np.array(a)), _s(p, a)))
    JD.texture_sequence(paths, str(tmp_path / "j"), 11)
    TD.texture_sequence(paths, str(tmp_path / "t"), 11, device="cpu")
    assert len(frames["port"]) == len(frames["jax"]) == 2
    for ja, ta in zip(frames["jax"], frames["port"]):
        _assert_uint8_close(ta, ja)
    for t in range(2):  # and the decoded files of both encoders
        name = f"{t:05d}.jpg"
        _assert_uint8_close(load_rgb(tmp_path / "t" / name),
                            load_rgb(tmp_path / "j" / name))


def _set0_tree(root):
    """A set-0 product tree (landscape 48×64) and a portrait set-k input
    tree (64×48) for replicate_texture_set."""
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    inside = ((yy - 24) / 14) ** 2 + ((xx - 30) / 20) ** 2 < 1
    amask = np.where(inside, 0, 255).astype(np.uint8)
    u = (4 + 2 * np.sin(yy / 5)).astype(np.float32)
    v = (-2 + 1.5 * np.sin(xx / 4)).astype(np.float32)
    fd = osp.join(root, "set0", "fd1")
    for d in ("Flow", "inpMasks", "wMasks"):
        os.makedirs(osp.join(fd, d, "seq0"))
    flo.flow_write(osp.join(fd, "Flow", "seq0", "00000.flo"), np.dstack([u, v]))
    save_image(osp.join(fd, "inpMasks", "seq0", "00000.png"), amask)
    save_image(osp.join(fd, "wMasks", "seq0", "00000.png"), 255 - amask)
    inp = osp.join(root, "setk")
    for d in ("orgRGB", "orgMasks"):
        os.makedirs(osp.join(inp, d, "seq0"))
    tex = _fake_texture(5, h // 2, w // 2)  # (48, 64, 3) -> portrait below
    save_image(osp.join(inp, "orgRGB", "seq0", "00000.jpg"),
               np.ascontiguousarray(tex.swapaxes(0, 1)))
    save_image(osp.join(inp, "orgMasks", "seq0", "00000.png"),
               np.ascontiguousarray((255 - amask).T // 255))
    return osp.join(root, "set0"), inp


@pytest.mark.parametrize("backend", ["host", "device"])
def test_replicate_texture_set_matches_jax(tmp_path, backend):
    set0, inp = _set0_tree(str(tmp_path))
    outs = {k: str(tmp_path / k) for k in ("j", "t")}
    assert JD.replicate_texture_set(set0, inp, outs["j"], [1], backend) == 1
    assert TD.replicate_texture_set(set0, inp, outs["t"], [1], backend,
                                    device="cpu") == 1
    rel = osp.join("fd1", "{}", "seq0", "00000.{}")
    for d, ext in (("Flow", "flo"), ("inpMasks", "png"), ("wMasks", "png")):
        src = osp.join(set0, rel.format(d, ext))
        got = osp.join(outs["t"], rel.format(d, ext))
        assert open(got, "rb").read() == open(src, "rb").read()
    for d in ("inpRGB", "wRGB"):
        j = load_rgb(osp.join(outs["j"], rel.format(d, "png")))
        t = load_rgb(osp.join(outs["t"], rel.format(d, "png")))
        assert t.shape == (48, 64, 3)
        np.testing.assert_array_equal(t, j)
    # the warp's temporary mask is gone; the linked set-0 wMask stays
    assert os.listdir(osp.join(outs["t"], "fd1", "wMasks", "seq0")) == [
        "00000.png"]


@pytest.fixture(scope="module")
def dual_run(tmp_path_factory):
    """run(texture_sets=2) and texture_gen in a subprocess where importing
    PIL, jax or arap_flow_tpu fails; returns (masks, out, textures, stdout)."""
    tmp = tmp_path_factory.mktemp("dmo")
    masks, out, tex = str(tmp / "masks"), str(tmp / "out"), str(tmp / "tex")
    _make_masks(masks)
    code = textwrap.dedent(f"""
        import functools, sys
        for name in ("PIL", "jax", "arap_flow_tpu", "bench"):
            sys.modules[name] = None  # any import of them raises
        import torch
        torch.set_num_threads(2)
        from arap_flow_tpu_torch.ops.solver import SolverConfig
        from arap_flow_tpu_torch.pipeline import dmo_gen, para_gen, texture_gen
        dmo_gen.PipelineFlags = functools.partial(para_gen.PipelineFlags,
                                                  match_downscale=2)
        dmo_gen.run({masks!r}, {out!r}, fds=[1], seed=3, texture_sets=2,
                    solver_cfg=SolverConfig(**{CFG!r}), device="cpu")
        texture_gen.main(["--output", {tex!r}, "--num", "3", "--size", "40",
                          "24", "--device", "cpu"])
        loaded = [m for m, v in sys.modules.items() if v is not None and
                  m.split(".")[0] in ("PIL", "jax", "arap_flow_tpu")]
        print("LOADED", loaded)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp),
                          env={**os.environ, "PYTHONPATH": ROOT},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return masks, out, tex, proc.stdout


def test_runs_without_pil_and_jax(dual_run):
    _, out, tex, stdout = dual_run
    assert "LOADED []" in stdout, stdout[-2000:]
    assert "set1: 2 pairs replicated" in stdout
    names = sorted(os.listdir(tex))
    assert len(names) == 3 and all(n.startswith("texture_0000") for n in names)
    assert load_rgb(osp.join(tex, names[0])).shape == (24, 40, 3)


def test_dmo_assemble_and_flow(dual_run, tmp_path):
    """The textured frames exist beside linked masks, and the object's
    texture moves with its mask: the flow recovers the motion.

    The flow is checked as tests/test_dmo_gen.py checks JAX's: seed 3 and
    the matcher at full size, on the first pair (a 2-frame tree: the same
    textured frames 0 and 1). The dual run's 2×-pooled matcher misses u by
    0.976 px on seed 3's texture, in both packages alike (JAX's stream,
    measured on the CPU)."""
    masks, out, _, _ = dual_run
    troot = osp.join(out, "set0", "textured")
    assert load_rgb(osp.join(troot, "orgRGB", "seq0", "00000.jpg")).shape == (
        H, W, 3)
    assert osp.islink(osp.join(troot, "orgMasks", "seq0", "00000.png"))
    with open(osp.join(out, "set0", "fd1", "all_files.list")) as f:
        assert len(f.read().splitlines()) == 2
    masks2 = str(tmp_path / "masks")
    _make_masks(masks2, n_frames=2)
    troot2 = TD.assemble(masks2, str(tmp_path / "out"), 3, device="cpu")
    for t in range(2):  # the dual run's frames
        name = osp.join("orgRGB", "seq0", f"{t:05d}.jpg")
        np.testing.assert_array_equal(load_rgb(osp.join(troot2, name)),
                                      load_rgb(osp.join(troot, name)))
    flags = TP.PipelineFlags(input=troot2, output=str(tmp_path / "fd1"),
                             fd=1, seed=0, device="cpu")
    TP.main_pipeline(flags, solver_cfg=SolverConfig(**CFG))
    u, v = flo.flow_read(str(tmp_path / "fd1" / "Flow" / "seq0" /
                             "00000.flo"))
    obj = load_mask(osp.join(masks, "orgMasks", "seq0", "00000.png")) == 1
    assert abs(np.median(u[obj]) - DX) < 0.6
    assert abs(np.median(v[obj]) - DY) < 0.6


def test_dual_run_flow_matches_jax(dual_run, tmp_path, monkeypatch):
    """The dual run's set-0 Flow, the product of its 2×-pooled matcher, is
    the JAX package's dmo_gen on the same masks and seed: each pair's
    median u and v over the object within 1e-3 px of JAX's, and every value
    within 1e-4 px."""
    from arap_flow_tpu.io.flo import flow_read as jax_flow_read
    from arap_flow_tpu.ops.solver import SolverConfig as JaxSolverConfig
    from arap_flow_tpu.pipeline import para_gen as JP

    masks, out, _, _ = dual_run
    monkeypatch.setattr(JD, "PipelineFlags",
                        functools.partial(JP.PipelineFlags, match_downscale=2))
    jout = str(tmp_path / "jax")
    JD.run(masks, jout, fds=[1], seed=3, texture_sets=2,
           solver_cfg=JaxSolverConfig(**CFG))
    for t in range(2):
        name = osp.join("fd1", "Flow", "seq0", f"{t:05d}.flo")
        tu, tv = flo.flow_read(osp.join(out, "set0", name))
        ju, jv = jax_flow_read(osp.join(jout, "set0", name))
        obj = load_mask(osp.join(masks, "orgMasks", "seq0",
                                 f"{t:05d}.png")) == 1
        for a, b in ((tu, ju), (tv, jv)):
            assert abs(np.median(a[obj]) - np.median(b[obj])) <= 1e-3
            assert np.abs(a - b).max() <= 1e-4


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def test_dual_texture_sets_share_flow_byte_identical(dual_run):
    _, out, _, _ = dual_run
    n_checked = 0
    for name in ("00000", "00001"):
        f0 = osp.join(out, "set0", "fd1", "Flow", "seq0", name + ".flo")
        f1 = osp.join(out, "set1", "fd1", "Flow", "seq0", name + ".flo")
        if not osp.exists(f0):
            continue
        assert _read(f0) == _read(f1), f"Flow differs for {name}"
        n_checked += 1
        # appearance products exist for both sets and differ (other texture
        # seeds); the warped masks are shared
        for d in ("inpRGB", "wRGB"):
            a0, a1 = (load_rgb(osp.join(out, s, "fd1", d, "seq0",
                                        name + ".png")).astype(np.int16)
                      for s in ("set0", "set1"))
            assert np.abs(a0 - a1).mean() > 2.0, f"{d} should differ"
        m0, m1 = (osp.join(out, s, "fd1", "wMasks", "seq0", name + ".png")
                  for s in ("set0", "set1"))
        assert _read(m0) == _read(m1)
        # set 1's wRGB is its inpRGB warped: the object moved
        w1, i1 = (load_rgb(osp.join(out, "set1", "fd1", d, "seq0",
                                    name + ".png")).astype(np.int16)
                  for d in ("wRGB", "inpRGB"))
        assert np.abs(w1 - i1).mean() > 0.5
    assert n_checked >= 1, "no pairs produced by set 0"


def test_dual_texture_sets_portrait_masks(tmp_path, pooled_matcher):
    """Portrait masks (H > W): para_gen transposes set 0's products, and set
    1's replication applies the same transpose to its frames."""
    masks = str(tmp_path / "masks")
    out = str(tmp_path / "out")
    _make_masks(masks, h=W, w=H)
    TD.run(masks, out, fds=[1], seed=3, texture_sets=2,
           solver_cfg=SolverConfig(**CFG), device="cpu")
    f0, f1 = (osp.join(out, s, "fd1", "Flow", "seq0", "00000.flo")
              for s in ("set0", "set1"))
    assert _read(f0) == _read(f1)
    i0, i1, w1 = (load_rgb(osp.join(out, s, "fd1", d, "seq0", "00000.png"))
                  for s, d in (("set0", "inpRGB"), ("set1", "inpRGB"),
                               ("set1", "wRGB")))
    assert i1.shape == i0.shape == (H, W, 3)
    assert w1.shape[:2] == (H, W)


def test_cli_flags_match_jax(monkeypatch):
    """The port takes JAX's dmo_gen flags, plus --device (default cuda:
    without CUDA it exits instead of moving to the CPU)."""
    seen = {}
    monkeypatch.setattr(TD, "run", lambda *a, **k: seen.update(a=a, k=k))
    argv = ["--masks", "M", "--output", "O", "--fd", "1", "2", "--seed", "4",
            "--multseg", "--schedule", "fast", "--mode", "batched",
            "--texture_sets", "2", "--warp_backend", "host"]
    TD.main(argv + ["--device", "cpu"])
    assert seen["a"] == ("M", "O", [1, 2], 4, True, "fast", "batched", 2,
                         "host")
    assert seen["k"] == {"device": torch.device("cpu")}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            TD.main(argv)
