"""The port's dataset pipeline (para_gen and its batch tools) against the JAX
package's, on small numpy-seeded PNG trees.

``main_pipeline`` runs in simple and batched mode on one tree of three
144×176 frames with two objects (multseg), with a short schedule (JAX
backend "xla", the port on the CPU). Tolerances: the per-object median flow
within 0.05 px (the full-solve bound of tests/test_pallas_pcg.py:59),
warped masks agreeing on > 98% of pixels, and the same all_files.list
relative to the output root. The host helpers (scan, gates, filter,
preprocessing, backgrounds) are held equal. ``--matcher binary`` runs a
stand-in matcher script with the reference's shell contract, as
tests/test_matcher_binary.py does for the JAX package.
"""

import dataclasses
import os
import os.path as osp
import stat

import numpy as np
import pytest
import torch
from PIL import Image

from arap_flow_tpu.io import constraints as JC
from arap_flow_tpu.io import flo as JF
from arap_flow_tpu.io.image import load_mask
from arap_flow_tpu.ops.solver import SolverConfig as JConfig
from arap_flow_tpu.pipeline import para_gen as JP
from arap_flow_tpu.pipeline import run_arap as JRA
from arap_flow_tpu.pipeline import run_warp as JRW
from arap_flow_tpu.pipeline import warp_tool as JW
from arap_flow_tpu_torch import __main__ as TMain
from arap_flow_tpu_torch.io import constraints as TC
from arap_flow_tpu_torch.io.image import save_image
from arap_flow_tpu_torch.ops.solver import SolverConfig as TConfig
from arap_flow_tpu_torch.pipeline import para_gen as TP
from arap_flow_tpu_torch.pipeline import run_arap as TRA
from arap_flow_tpu_torch.pipeline import run_warp as TRW

torch.set_num_threads(2)

H, W = 144, 176
SHORT = dict(num_anneal=4, gn_iters=3, max_pcg_iters=120, pcg_iters=120.0)
# (centre y, x), (radius y, x), (dx, dy) per frame
OBJECTS = (((40, 48), (30, 40), (3, 2)), ((100, 120), (26, 34), (-2, 3)))


def _texture(seed):
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(60, 255, (H // 8 + 2, W // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:H, :W]
    detail = np.kron(rng.uniform(-25, 25, (H // 2 + 1, W // 2 + 1, 3)),
                     np.ones((2, 2, 1)))[:H, :W]
    return np.clip(base + detail, 0, 255).astype(np.uint8)


def _make_tree(root, n_frames=3):
    """PNG frames and masks (written with the port's codec) of two
    textured objects translating over a static dark background."""
    for d in ("orgRGB", "orgMasks"):
        os.makedirs(osp.join(root, d, "seq0"))
    bg = _texture(2) // 3
    texs = [_texture(1), _texture(3)]
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        for k, ((cy, cx), (ry, rx), (dx, dy)) in enumerate(OBJECTS):
            ob = ((yy - cy - dy * t) / ry) ** 2 + ((xx - cx - dx * t) / rx) ** 2 < 1
            img[ob] = texs[k][yy[ob] - dy * t, xx[ob] - dx * t]
            mask[ob] = k + 1
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' main_pipeline in both modes on one tree."""
    root = tmp_path_factory.mktemp("pg")
    inp = str(root / "in")
    _make_tree(inp)
    out = {}
    for mode in ("batched", "simple"):
        jo, to = str(root / f"j_{mode}"), str(root / f"t_{mode}")
        out[("jax", mode)] = (jo, JP.main_pipeline(
            JP.PipelineFlags(input=inp, output=jo, multseg=True, seed=0,
                             mode=mode),
            solver_cfg=JConfig(**SHORT, backend="xla")))
        out[("torch", mode)] = (to, TP.main_pipeline(
            TP.PipelineFlags(input=inp, output=to, multseg=True, seed=0,
                             mode=mode, device="cpu"),
            solver_cfg=TConfig(**SHORT)))
        # each run's chunk record (the next run clears it)
        out[("jax", mode, "chunks")] = list(JP.CHUNK_STATS)
        out[("torch", mode, "chunks")] = list(TP.CHUNK_STATS)
    return inp, out


@pytest.mark.parametrize("mode", ["batched", "simple"])
def test_main_pipeline_matches_jax(runs, mode):
    inp, out = runs
    (jo, jl), (to, tl) = out[("jax", mode)], out[("torch", mode)]
    assert len(tl) == len(jl) == 2
    assert [osp.relpath(p, to) for line in tl for p in line.split(" ")] == [
        osp.relpath(p, jo) for line in jl for p in line.split(" ")]
    with open(osp.join(to, "all_files.list")) as f:
        assert f.read().splitlines() == tl
    for t in range(2):
        name = f"{t:05d}"
        tu, tv = JF.flow_read(osp.join(to, "Flow", "seq0", name + ".flo"))
        ju, jv = JF.flow_read(osp.join(jo, "Flow", "seq0", name + ".flo"))
        mk = load_mask(osp.join(inp, "orgMasks", "seq0", name + ".png"))
        for k, (_, _, (dx, dy)) in enumerate(OBJECTS):
            obj = mk == k + 1
            for a, b in ((tu, ju), (tv, jv)):
                assert abs(np.median(a[obj]) - np.median(b[obj])) < 0.05
            # and the flow is the objects' translation
            assert abs(np.median(tu[obj]) - dx) < 0.6
            assert abs(np.median(tv[obj]) - dy) < 0.6
        wt = load_mask(osp.join(to, "wMasks", "seq0", name + ".png"))
        wj = load_mask(osp.join(jo, "wMasks", "seq0", name + ".png"))
        assert (wt == wj).mean() > 0.98
        for d in ("inpRGB", "inpMasks"):
            a = np.array(Image.open(osp.join(to, d, "seq0", name + ".png")))
            b = np.array(Image.open(osp.join(jo, d, "seq0", name + ".png")))
            np.testing.assert_array_equal(a, b)
        tc, jc = (set(map(tuple, TC.read_constraint_file(
            osp.join(o, "tmpCnstr", "seq0", name + ".txt")).tolist()))
            for o in (to, jo))
        assert len(tc & jc) >= 0.97 * len(tc | jc)


def test_chunk_stats_of_a_run_match_jax(runs):
    """The batched runs' CHUNK_STATS: one chunk of the 2 pairs in both
    packages; the simple runs collect no chunk."""
    _, out = runs
    for mode, want in (("batched", [2]), ("simple", [])):
        for pkg in ("jax", "torch"):
            assert [p for p, _, _ in out[(pkg, mode, "chunks")]] == want


def test_resume_skips_generated_pairs(runs):
    inp, out = runs
    to, _ = out[("torch", "batched")]
    flags = TP.PipelineFlags(input=inp, output=to, resume=True, device="cpu")
    assert TP.scan_pairs(flags) == []


def _scan_tree(root):
    """Empty files with awkward names: a repeated digit run, missing masks,
    a missing next frame, two sequences."""
    names = {
        "s1": ["001_001.jpg", "001_002.jpg", "001_003.jpg", "001_005.jpg"],
        "s2": ["frame0009.png", "frame0010.png", "frame0011.png",
               "frame0012.png", "FRAME0013.JPG"],
    }
    for seq, files in names.items():
        os.makedirs(osp.join(root, "orgRGB", seq))
        os.makedirs(osp.join(root, "orgMasks", seq))
        for f in files:
            open(osp.join(root, "orgRGB", seq, f), "w").close()
            if f != "frame0011.png":
                stem = osp.splitext(f)[0]
                open(osp.join(root, "orgMasks", seq, stem + ".png"), "w").close()


@pytest.mark.parametrize("fd,resume,shard", [
    (1, False, None), (2, False, None), (1, True, None), (1, False, (1, 3)),
])
def test_scan_pairs_equal(tmp_path, fd, resume, shard):
    _scan_tree(str(tmp_path / "in"))
    out = str(tmp_path / "out")
    os.makedirs(osp.join(out, "Flow", "s1"))
    open(osp.join(out, "Flow", "s1", "001_001.flo"), "w").close()
    kw = dict(input=str(tmp_path / "in"), output=out, fd=fd, resume=resume,
              shard=shard)
    jp = JP.scan_pairs(JP.PipelineFlags(**kw))
    tp = TP.scan_pairs(TP.PipelineFlags(**kw))
    assert [vars(p) for p in tp] == [vars(p) for p in jp]
    assert len(jp) > 0


def test_mask_gates_equal():
    rng = np.random.default_rng(0)
    for n in (0, 5, 10, 11, 40):
        m1 = np.zeros((20, 20), np.uint8)
        m1.ravel()[rng.choice(400, n, replace=False)] = rng.integers(1, 3)
        m2 = np.roll(m1, 3)
        for gate in ("count", "refsum"):
            assert TP.has_mask(m1, m2, gate) == JP.has_mask(m1, m2, gate)


def test_constraint_filter_and_files_equal(tmp_path):
    rng = np.random.default_rng(1)
    m1 = rng.integers(0, 3, (30, 40)).astype(np.uint8)
    m2 = np.roll(m1, 2, axis=1)
    matches = rng.integers(-5, 80, (300, 4)).astype(np.int32)
    matches[::3, 2:] = matches[::3, :2] + rng.integers(-3, 4, (100, 2))
    for got, ref in zip(TC.filter_matches(matches, m1, m2),
                        JC.filter_matches(matches, m1, m2)):
        np.testing.assert_array_equal(got, ref)
    assert all(
        TC.valid_constraint(*row, m1, m2) == JC.valid_constraint(*row, m1, m2)
        for row in matches.tolist())
    assert TC.MAX_CONSTRAINT_DIST == JC.MAX_CONSTRAINT_DIST
    kept, _ = TC.filter_matches(matches, m1, m2)
    TC.write_constraint_file(tmp_path / "t.txt", kept)
    JC.write_constraint_file(tmp_path / "j.txt", kept)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    (tmp_path / "m.txt").write_text("1 2 3 4 0.5\n7.0 8 9 10\nbad\n")
    np.testing.assert_array_equal(TC.read_matches(tmp_path / "m.txt"),
                                  JC.read_matches(tmp_path / "m.txt"))
    assert TC.filter_matches(matches[:0], m1, m2)[0].shape == (0, 4)


@pytest.mark.parametrize("shape,size", [((30, 50), None), ((50, 30), None),
                                        ((50, 30), (40, 24)),
                                        ((30, 50), (64, 36))])
def test_scale_rotate_equal(shape, size):
    rng = np.random.default_rng(2)
    im = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    mk = rng.integers(0, 4, shape).astype(np.uint8)
    jpre, jim, jmk = JP.scale_rotate(Image.fromarray(im), Image.fromarray(mk),
                                     size)
    tpre, tim, tmk = TP.scale_rotate(im, mk, size)
    assert tpre == jpre
    np.testing.assert_array_equal(tim, np.array(jim))
    np.testing.assert_array_equal(tmk, np.array(jmk))
    with pytest.raises(ValueError):
        TP.scale_rotate(im, mk[:-1], size)


def test_backgrounds_equal(tmp_path):
    """The same seed draws the same backgrounds in the same order."""
    rng = np.random.default_rng(3)
    for i, ext in enumerate(("png", "jpg", "png")):
        Image.fromarray(rng.integers(0, 255, (40 + 9 * i, 70, 3)).astype(
            np.uint8)).save(tmp_path / f"bg{i}.{ext}")
    (tmp_path / "broken.png").write_bytes(b"not an image")
    jpool = JP.BackgroundPool(str(tmp_path), np.random.default_rng(5))
    tpool = TP.BackgroundPool(str(tmp_path), np.random.default_rng(5))
    im = rng.integers(0, 255, (36, 60, 3)).astype(np.uint8)
    mk = (rng.uniform(size=(36, 60)) > 0.5).astype(np.uint8)
    for _ in range(7):
        jb, tb = jpool.draw(im.shape), tpool.draw(im.shape)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(TP.add_bg(im, mk, tb),
                                      JP.add_bg(im, mk, jb))
    assert sorted(tpool.paths) == sorted(jpool.paths)
    assert TP.BackgroundPool(None, rng).draw(im.shape) is None


def test_parse_args_equal():
    argv = ["--input", "in/", "--output", "out", "--multseg", "--narap", "3",
            "--fd", "2", "--mode", "batched", "--seed", "4", "--shard", "1/2",
            "--match_downscale", "2", "--mask_gate", "refsum", "--resume"]
    j = vars(JP.parse_args(argv))
    t = vars(TP.parse_args(argv + ["--device", "cpu"]))
    assert t.pop("device") == "cpu"
    assert t == j
    assert TP.parse_args(["--input", "a", "--output", "b", "--device", "cpu",
                          "--exec_pack", "d"]).warmup
    with pytest.raises(SystemExit):
        TP.parse_args(["--input", "a", "--output", "b", "--fd", "0"])


@pytest.mark.parametrize("flags,error", [
    (dict(mode="bogus"), ValueError),
    (dict(matcher="bogus"), ValueError),
    (dict(matcher="binary", dm_bin="/nonexistent/dm"), FileNotFoundError)])
def test_unported_options_raise(tmp_path, flags, error):
    """Every mode is ported (--mode sharded included); what is left to
    refuse is a mode or matcher that does not exist."""
    f = TP.PipelineFlags(input=str(tmp_path), output=str(tmp_path / "o"),
                         device="cpu", **flags)
    with pytest.raises(error):
        TP.main_pipeline(f, solver_cfg=TConfig(**SHORT))


def test_cli_registers_pipeline_commands(tmp_path):
    for name in ("para_gen", "generate", "run_arap", "run_warp"):
        assert name in TMain.COMMANDS
    with pytest.raises(SystemExit):  # argparse refuses an unknown mode
        TMain.main(["para_gen", "--input", str(tmp_path), "--output",
                    str(tmp_path / "o"), "--mode", "bogus", "--device",
                    "cpu"])


def test_sharded_mode_writes_the_batched_products(runs, tmp_path, capsys):
    """--mode sharded --device cpu (a mesh of the one CPU) writes products
    byte-identical to --mode batched's, and says how many devices it
    shards over."""
    inp, out = runs
    to, ref = out[("torch", "batched")]
    lines = TP.main_pipeline(
        TP.PipelineFlags(input=inp, output=str(tmp_path), multseg=True,
                         seed=0, mode="sharded", device="cpu"),
        solver_cfg=TConfig(**SHORT))
    assert "sharded over 1 devices" in capsys.readouterr().out
    assert [osp.relpath(p, str(tmp_path)) for ln in lines
            for p in ln.split(" ")] == [osp.relpath(p, to) for ln in ref
                                        for p in ln.split(" ")]
    n = 0
    for root, _, files in os.walk(to):
        for f in files:
            if f == "all_files.list":
                continue
            a = osp.join(root, f)
            with open(a, "rb") as fa, open(
                    osp.join(str(tmp_path), osp.relpath(a, to)), "rb") as fb:
                assert fa.read() == fb.read(), a
            n += 1
    assert n >= 2 * 6


def test_host_raster_switches_sharded_to_simple(tmp_path, monkeypatch,
                                                capsys):
    """ARAP_RASTER=host applies before the mode check, as in the JAX
    package: --mode sharded becomes simple instead of raising."""
    monkeypatch.setenv("ARAP_RASTER", "host")
    f = TP.PipelineFlags(input=str(tmp_path), output=str(tmp_path / "o"),
                         device="cpu", mode="sharded")
    assert TP.main_pipeline(f, solver_cfg=TConfig(**SHORT)) == []
    assert f.mode == "simple"
    assert "forcing --mode simple" in capsys.readouterr().out


def test_main_pipeline_passes_framework_crop(tmp_path, monkeypatch):
    """main_pipeline builds its deformer with FrameworkConfig.crop, as the
    JAX package's does (utils/config.py:34, para_gen.py:833)."""
    from arap_flow_tpu_torch.utils.config import FrameworkConfig

    seen = []

    class Spy(TP.ArapDeformer):
        def __init__(self, *a, **k):
            seen.append(k.get("crop"))
            super().__init__(*a, **k)

    monkeypatch.setattr(TP, "ArapDeformer", Spy)
    flags = dict(input=str(tmp_path), output=str(tmp_path / "o"),
                 device="cpu")
    TP.main_pipeline(TP.PipelineFlags(**flags), solver_cfg=TConfig(**SHORT))
    real = FrameworkConfig.from_env
    monkeypatch.setattr(TP.FrameworkConfig, "from_env", classmethod(
        lambda cls, **k: dataclasses.replace(real(**k), crop=False)))
    TP.main_pipeline(TP.PipelineFlags(**flags), solver_cfg=TConfig(**SHORT))
    assert seen == [True, False]


def test_run_warp_and_run_arap_scans_equal(runs, tmp_path):
    """run_warp's job scan and warps over a para_gen output tree, and
    run_arap's Sintel list, equal the JAX tools'."""
    _, out = runs
    to, _ = out[("torch", "batched")]
    root = tmp_path / "w"
    os.makedirs(root)
    os.symlink(to, root / "fd1")
    jobs = TRW.scan_jobs(str(root), [1, 2])
    assert jobs == JRW.scan_jobs(str(root), [1, 2]) and len(jobs) == 2
    rgb, msk, flo_path, _, _ = jobs[0]
    assert TMain.main(["run_warp", "--root", str(root), "--fd", "1",
                       "--device", "cpu"]) == 0
    jw, jm = JW.warp_image(rgb, msk, flo_path, str(tmp_path / "jw.png"),
                           str(tmp_path / "jm.png"), backend="device")
    wm = load_mask(root / "fd1" / "wMasks" / "seq0" / "00000.png")
    assert (wm == jm).mean() > 0.98

    sintel = tmp_path / "sintel"
    for sub in ("clean/alley", "masks/clean/alley", "cnstr/clean/alley"):
        os.makedirs(sintel / sub)
    for i in range(2):
        for sub, ext in (("clean/alley", "png"), ("masks/clean/alley", "png"),
                         ("cnstr/clean/alley", "txt")):
            (sintel / sub / f"frame_{i:04d}.{ext}").write_text("")
    tl = TRA.build_sintel_list(str(sintel), ["clean", "final"])
    jl = JRA.build_sintel_list(str(sintel), ["clean", "final"])
    assert [vars(f) for f in tl] == [vars(f) for f in jl] and len(tl) == 2


def test_failed_chunk_retries_per_pair(runs, tmp_path, monkeypatch):
    """A chunk whose batched dispatch fails is solved again pair by pair
    on the crop path, with the batched run's products."""
    from arap_flow_tpu_torch.pipeline import batch as TB

    def poisoned(self):
        raise RuntimeError("poisoned chunk")

    monkeypatch.setattr(TB.BatchRunner, "flush", poisoned)
    inp, out = runs
    to, ref = out[("torch", "batched")]
    lines = TP.main_pipeline(
        TP.PipelineFlags(input=inp, output=str(tmp_path), multseg=True,
                         seed=0, mode="batched", device="cpu"),
        solver_cfg=TConfig(**SHORT))
    assert [osp.relpath(p, str(tmp_path)) for line in lines
            for p in line.split(" ")] == [osp.relpath(p, to) for line in ref
                                          for p in line.split(" ")]
    for t in range(2):
        name = osp.join("Flow", "seq0", f"{t:05d}.flo")
        u, v = JF.flow_read(osp.join(str(tmp_path), name))
        ru, rv = JF.flow_read(osp.join(to, name))
        assert np.abs(u - ru).max() < 0.05 and np.abs(v - rv).max() < 0.05


def _fake_dm(tmp_path, matches_dir, status=0):
    """A stand-in matcher binary: records its argv, then copies the match
    file named after its first frame (``<basename>.txt`` in `matches_dir`)
    to its -out path, and exits with `status`."""
    argv_file = tmp_path / "dm_argv.txt"
    script = tmp_path / "fake_dm.sh"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {argv_file}\n'
        # args: src1 src2 -nt 0 -out OUT -ngh_rad 100
        f'cp {matches_dir}/$(basename "$1").txt "$6" 2>/dev/null || '
        'printf "20 20 23 22\\n" > "$6"\n'
        f"exit {status}\n")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script), argv_file


def _translation_matches(root, matches_dir, n_pairs=2):
    """For each pair t of _make_tree's tree, the objects' grid points
    moved by their known translations, one file per first frame."""
    os.makedirs(matches_dir, exist_ok=True)
    for t in range(n_pairs):
        mk = load_mask(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"))
        rows = []
        for k, (_, _, (dx, dy)) in enumerate(OBJECTS):
            ys, xs = np.nonzero(mk[::4, ::4] == k + 1)
            rows += [f"{4 * x} {4 * y} {4 * x + dx} {4 * y + dy}"
                     for y, x in zip(ys, xs)]
        with open(osp.join(matches_dir, f"{t:05d}.png.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("size", [None, (160, 120)])
def test_binary_matcher_reads_the_matched_frames(tmp_path, size):
    """The binary sees the preprocessed frames (saved by the port's codec)
    when --size resizes them, else the originals; as the JAX prep_pair."""
    inp = str(tmp_path / "in")
    _make_tree(inp, n_frames=2)
    dm, argv_file = _fake_dm(tmp_path, str(tmp_path / "none"))
    kw = dict(input=inp, matcher="binary", dm_bin=dm, size=size)
    for tag, mod in (("t", TP), ("j", JP)):
        flags = mod.PipelineFlags(output=str(tmp_path / tag), **kw)
        (p,) = mod.scan_pairs(flags)
        bgpool = mod.BackgroundPool(None, np.random.default_rng(0))
        assert mod.prep_pair(flags, p, bgpool) is not None
        argv = argv_file.read_text().split()
        argv_file.unlink()
        src = (p.rgb1_gen, p.rgb2_gen) if size else (p.rgb1_org, p.rgb2_org)
        assert argv == [*src, "-nt", "0", "-out", p.cstr_tmp, "-ngh_rad",
                        "100"]
        if size:
            frame = load_mask(p.rgb2_gen)
            assert frame.shape == (size[1], size[0])
    if size:  # the saved preprocessed frame 2 is the JAX package's
        with Image.open(tmp_path / "j" / "wRGB" / "seq0" / "00000.png") as im:
            np.testing.assert_array_equal(
                np.array(im), np.array(Image.open(
                    tmp_path / "t" / "wRGB" / "seq0" / "00000.png")))


def test_binary_matcher_pipeline_matches_jax(tmp_path):
    """A batched run on the stand-in's translation matches: the flow of
    each object is its translation, within 0.05 px of the JAX run's on
    > 99% of its pixels; a matcher that exits non-zero fails its pairs and
    the run goes on; a missing binary fails the run at once."""
    inp = str(tmp_path / "in")
    _make_tree(inp)
    _translation_matches(inp, str(tmp_path / "m"))
    dm, _ = _fake_dm(tmp_path, str(tmp_path / "m"))
    kw = dict(input=inp, multseg=True, seed=0, mode="batched",
              matcher="binary", dm_bin=dm)
    short = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)
    tl = TP.main_pipeline(TP.PipelineFlags(output=str(tmp_path / "t"),
                                           device="cpu", **kw),
                          solver_cfg=TConfig(**short))
    jl = JP.main_pipeline(JP.PipelineFlags(output=str(tmp_path / "j"), **kw),
                          solver_cfg=JConfig(**short, backend="xla"))
    assert len(tl) == len(jl) == 2
    for t in range(2):
        name = osp.join("Flow", "seq0", f"{t:05d}.flo")
        tu, tv = JF.flow_read(tmp_path / "t" / name)
        ju, jv = JF.flow_read(tmp_path / "j" / name)
        mk = load_mask(osp.join(inp, "orgMasks", "seq0", f"{t:05d}.png"))
        for k, (_, _, (dx, dy)) in enumerate(OBJECTS):
            obj = mk == k + 1
            assert abs(np.median(tu[obj]) - dx) < 0.1
            assert abs(np.median(tv[obj]) - dy) < 0.1
            # per pixel too, but where the other object's warp lands the
            # composite takes its flow, and the rasterizers' coverage
            # differs at a few pixels there
            close = (np.abs(tu - ju) < 0.05) & (np.abs(tv - jv) < 0.05)
            assert close[obj].mean() > 0.99
    bad, _ = _fake_dm(tmp_path / "m", str(tmp_path / "m"), status=3)
    lines = TP.main_pipeline(
        TP.PipelineFlags(output=str(tmp_path / "bad"), device="cpu",
                         **{**kw, "dm_bin": bad}), solver_cfg=TConfig(**short))
    assert lines == []
    with pytest.raises(FileNotFoundError):
        TP.main_pipeline(TP.PipelineFlags(output=str(tmp_path / "x"),
                                          device="cpu",
                                          **{**kw, "dm_bin": "/nonexistent"}))


def test_config_switches(monkeypatch):
    """The writer's switches: the port's defaults are JAX's;
    ARAP_ASYNC_IO=0 turns the asynchronous writer off, any other value is
    ignored."""
    from arap_flow_tpu.utils.config import FrameworkConfig as JFramework
    from arap_flow_tpu_torch.utils.config import FrameworkConfig

    cfg = FrameworkConfig.from_env()
    j = JFramework()
    assert (cfg.async_io, cfg.io_threads) == (j.async_io, j.io_threads)
    monkeypatch.setenv("ARAP_ASYNC_IO", "0")
    assert FrameworkConfig.from_env().async_io is False
    monkeypatch.setenv("ARAP_ASYNC_IO", "yes")  # not 0/1: ignored
    assert FrameworkConfig.from_env().async_io is True
