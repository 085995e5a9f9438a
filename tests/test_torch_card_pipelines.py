"""The port's dataset pipelines and entry points on the card, at 19x8x400:
``para_gen`` on a synthetic 854x480 PNG tree (batched, and sharded over a
mesh of the one card; with ``--warmup`` in a fresh process; with a stand-in
binary matcher) and on a 1280x720 JPEG tree with ``--size`` and
``--bg_dir``; the texture families against the constants recorded from JAX
and against the CPU; ``dmo_gen``; the subpatch search; ``generate``,
``run_arap``, ``run_warp``, ``warp``, ``texture_gen`` as a user types them;
the ZNCC kernel at the matcher's Sintel shapes; and the endurance run, cut.
Every test needs the card and skips without it.
"""

import os
import shutil
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io.constraints import write_constraint_file
from arap_flow_tpu_torch.io.flo import flow_read
from arap_flow_tpu_torch.io.image import load_mask, load_rgb, save_image
from arap_flow_tpu_torch.ops import matching, textures
from arap_flow_tpu_torch.ops.solver import SolverConfig
from arap_flow_tpu_torch.pipeline import para_gen
from arap_flow_tpu_torch.utils import prng
from torch_card import card  # noqa: F401
from torch_card import (DMO_FDS, FRAME_H, FRAME_W, PIPE_FRAMES, PIPE_OBJECTS,
                        ROOT, SINTEL_H, SINTEL_W, TEX_H, TEX_JAX_DRAWS,
                        TEX_JAX_SUMS, TEX_W, TEXGEN_JAX_FIRST, TEXGEN_SEED,
                        assert_texture_sums, assert_zncc_matches_plain,
                        check_pipeline_products, dmo_flow_gate,
                        make_mask_tree, make_pipeline_tree,
                        predicted_launches, read_bytes, read_counts,
                        rgb_texture, tree_digest, zero_counts, zncc_inputs)

N_PAIRS = PIPE_FRAMES - 1


def _para_gen(inp: str, out: str, **kw) -> list:
    flags = para_gen.PipelineFlags(input=inp, output=out, multseg=True,
                                   seed=0, **{"mode": "batched",
                                              "device": "cuda", **kw})
    lines = para_gen.main_pipeline(flags, solver_cfg=SolverConfig())
    torch.cuda.synchronize()
    return lines


class Tree(NamedTuple):
    inp: str
    out: str
    lines: list
    launches: dict
    digest: dict


@pytest.fixture(scope="module")
def tree(card, tmp_path_factory) -> Tree:
    """The para_gen tree (5 frames, 4 pairs, one matcher sub-batch) and its
    cold batched multseg run."""
    root = tmp_path_factory.mktemp("para_gen")
    inp, out = str(root / "in"), str(root / "out")
    make_pipeline_tree(inp)
    zero_counts()
    lines = _para_gen(inp, out)
    return Tree(inp, out, lines, read_counts(), tree_digest(out, lines))


@pytest.mark.cuda
def test_para_gen_batched(tree, tmp_path):
    """The kernels' launches as the code's shapes predict (one matcher call
    and one PCG call a chunk and GN step, nothing else), at least 20 kept
    constraints on each object of each pair, the list file and every
    product, each object's median |flow − t| < 1 px; a warm run into a fresh
    tree the same."""
    inp, out, lines, launches, _ = tree
    cfg = SolverConfig()
    z_exp, p_exp, kept = predicted_launches(inp, out, cfg)
    assert (launches["zncc_search"], launches["pcg_fixed"],
            launches["pcg_fixed_tall"],
            launches["anneal_solve_fused"]) == (z_exp, p_exp, 0, 0)
    assert len(kept) == N_PAIRS * len(PIPE_OBJECTS)
    assert min(kept.values()) >= 20, kept
    check_pipeline_products(inp, out, lines)
    zero_counts()
    warm = _para_gen(inp, str(tmp_path / "warm"))
    assert (read_counts()["zncc_search"],
            read_counts()["pcg_fixed"]) == (z_exp, p_exp)
    check_pipeline_products(inp, str(tmp_path / "warm"), warm)


# The JPEG tree: DAVIS's full resolution, 5 frames, brought to 854x480 by
# --size; a rigid textured ellipse and the JAX gates' non-rigid object
# (scripts/synth_nonrigid.py) at 1.5x the bench's scale, so both are the
# bench's size after the resize; 3 JPEG backgrounds.
JPEG_H, JPEG_W, JPEG_FRAMES, JPEG_QUALITY = 720, 1280, 5, 95
JPEG_SIZE = (FRAME_W, FRAME_H)  # --size 854 480
JPEG_RIGID = ((200, 330), (135, 210), (9, 13))  # centre, radii, (dy, dx) a frame
JPEG_NONRIGID = ((470, 930), (90, 135), 9.0, (6, -10))  # centre, radii, amp, drift
JPEG_BACKGROUNDS = ((600, 1000), (720, 1280), (540, 960))


def _luma_texture(H: int, W: int, seed: int) -> np.ndarray:
    """Gray 8x8 blocks and 2x2 detail, with a gentle colour tint in 32x32
    blocks and no clipping: the detail is in luma, as in natural frames.
    (make_textures' saturated per-channel colour changes every 2 and 8 px
    are chroma detail that 4:2:0 discards: 24-30 dB at quality 95, PIL's
    encoder as the port's.)"""
    rng = np.random.default_rng(seed)

    def blocks(n, lo, hi, ch):
        return np.kron(rng.uniform(lo, hi, (H // n + 2, W // n + 2, ch)),
                       np.ones((n, n, 1)))[:H, :W]

    img = blocks(8, 50, 200, 1) + blocks(32, -25, 25, 3) + blocks(2, -25, 25, 1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _make_jpeg_tree(root: str, nr) -> list:
    """The JPEG tree, every image a JPEG from the port's encoder (the masks
    PNG); returns (path, source array) of every JPEG."""
    H, W = JPEG_H, JPEG_W
    for d in ("orgRGB/seq0", "orgMasks/seq0", "bg"):
        os.makedirs(os.path.join(root, d))
    tex = _luma_texture(H, W, 7)
    bg = (_luma_texture(H, W, 8)[::-1] * 0.4).astype(np.uint8)
    (cy, cx), (ry, rx), (dy, dx) = JPEG_RIGID
    (ny, nx), (nry, nrx), amp, (ndy, ndx) = JPEG_NONRIGID
    yy, xx = np.mgrid[0:H, 0:W]
    written = []
    for t in range(JPEG_FRAMES):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        ob = (((yy - cy - dy * t) / ry) ** 2
              + ((xx - cx - dx * t) / rx) ** 2) < 1.0
        img[ob] = tex[(yy[ob] - dy * t) % H, (xx[ob] - dx * t) % W]
        mask[ob] = 1
        nr.draw_nonrigid(img, mask, tex, 2, ny + ndy * t, nx + ndx * t, nry,
                         nrx, amp, t)
        path = os.path.join(root, "orgRGB", "seq0", f"{t:05d}.jpg")
        save_image(path, img, quality=JPEG_QUALITY)
        save_image(os.path.join(root, "orgMasks", "seq0", f"{t:05d}.png"),
                   mask)
        written.append((path, img))
    for i, (bh, bw) in enumerate(JPEG_BACKGROUNDS):
        img = _luma_texture(bh, bw, 30 + i)
        path = os.path.join(root, "bg", f"b{i}.jpg")
        save_image(path, img, quality=JPEG_QUALITY)
        written.append((path, img))
    return written


def _check_jpeg_products(out: str, lines, nr, pre_masks) -> None:
    """The list file, the products, and the flow gates in preprocessed
    coordinates: the rigid object's median |flow − s·(dx, dy)| < 1 px, the
    non-rigid object's median EPE < 0.8 px against the analytic flow
    mapped through the resize (nr_check_epe with the object's centre, radii
    and amplitude in preprocessed pixels)."""
    with open(os.path.join(out, "all_files.list")) as f:
        listed = f.read().splitlines()
    assert len(listed) == JPEG_FRAMES - 1 and listed == lines
    for t, line in enumerate(listed):
        rgb1, rgb2, flo = line.split(" ")
        for path in (rgb1, rgb2):
            assert load_rgb(path).shape == (FRAME_H, FRAME_W, 3), path
        for sub in ("inpMasks", "wMasks"):
            m = load_mask(os.path.join(out, sub, "seq0", f"{t:05d}.png"))
            assert m.shape == (FRAME_H, FRAME_W), (sub, t)
        u, v = flow_read(flo)
        assert u.shape == (FRAME_H, FRAME_W), flo
        assert np.isfinite(u).all() and np.isfinite(v).all(), flo
    r = max((JPEG_SIZE[0] + 10) / JPEG_W, (JPEG_SIZE[1] + 10) / JPEG_H)
    w, h = int(JPEG_W * r), int(JPEG_H * r)
    left, upper = w // 2 - JPEG_SIZE[0] // 2, h // 2 - JPEG_SIZE[1] // 2
    sx, sy = w / JPEG_W, h / JPEG_H  # the resize's own scales

    def pre(cy, cx):  # a point of the original frame, in preprocessed pixels
        return sy * (cy + 0.5) - 0.5 - upper, sx * (cx + 0.5) - 0.5 - left

    (_, _, (dy, dx)) = JPEG_RIGID
    (ny, nx), (nry, nrx), amp, (ndy, ndx) = JPEG_NONRIGID
    s = 0.5 * (sx + sy)
    for t in range(JPEG_FRAMES - 1):
        u, v = flow_read(os.path.join(out, "Flow", "seq0", f"{t:05d}.flo"))
        mk = pre_masks[t]
        obj = mk == 1
        err = float(np.median(np.hypot(u[obj] - sx * dx, v[obj] - sy * dy)))
        assert err < 1.0 and obj.sum() > 1000, (t, err)
        c0 = pre(ny + ndy * t, nx + ndx * t)
        c1 = pre(ny + ndy * (t + 1), nx + ndx * (t + 1))
        ok, msg = nr.nr_check_epe(u, v, mk, 2, c0, c1, s * nry, s * nrx,
                                  s * amp, t, thresh=0.8,
                                  label=f"pair {t} non-rigid object")
        assert ok and (mk == 2).sum() > 1000 and "skipped" not in msg, msg


@pytest.mark.cuda
def test_para_gen_jpeg_resized_with_backgrounds(card, tmp_path):
    """para_gen --mode batched --multseg --size 854 480 --bg_dir --seed 0
    on the JPEG tree, cold and warm: every decoded file ≥ 30 dB PSNR
    against its source; the list file and every product; no failed
    asynchronous write; the kernels' launches as predicted; in
    preprocessed coordinates the rigid object's median |flow − s·t| < 1 px
    and the non-rigid object's median EPE < 0.8 px."""
    from arap_flow_tpu_torch.tools import endurance

    nr = endurance.synth_nonrigid()
    inp = str(tmp_path / "in")
    written = _make_jpeg_tree(inp, nr)
    for path, src in written:
        mse = float(np.mean((load_rgb(path).astype(np.float64) - src) ** 2))
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 30.0, path
    pre_masks = [para_gen.scale_rotate(
        load_rgb(written[t][0]), load_mask(os.path.join(
            inp, "orgMasks", "seq0", f"{t:05d}.png")), JPEG_SIZE)[2]
        for t in range(JPEG_FRAMES - 1)]
    for run in ("cold", "warm"):
        out = str(tmp_path / run)
        zero_counts()
        lines = _para_gen(inp, out, size=JPEG_SIZE,
                          bg_dir=os.path.join(inp, "bg"))
        launches = read_counts()
        assert para_gen.WRITE_ERRORS == 0
        z_exp, p_exp, _ = predicted_launches(inp, out, SolverConfig(),
                                             pre_masks)
        assert (launches["zncc_search"], launches["pcg_fixed"],
                launches["pcg_fixed_tall"],
                launches["anneal_solve_fused"]) == (z_exp, p_exp, 0, 0)
        _check_jpeg_products(out, lines, nr, pre_masks)


def _write_stand_in_matcher(root: str, inp: str, n_pairs: int) -> str:
    """A stand-in external matcher (the reference's DeepMatching contract,
    ``DM src1 src2 -nt 0 -out CSTR -ngh_rad 100``): a shell script that
    copies the match file prepared for its first frame, the objects' grid
    points every 8 px moved by their known translations."""
    mdir = os.path.join(root, "matches")
    os.makedirs(mdir)
    for t in range(n_pairs):
        mk = load_mask(os.path.join(inp, "orgMasks", "seq0", f"{t:05d}.png"))
        rows = []
        for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
            ys, xs = np.nonzero(mk[::8, ::8] == k + 1)
            rows += [f"{8 * x} {8 * y} {8 * x + dx} {8 * y + dy} 0.9"
                     for y, x in zip(ys, xs)]
        with open(os.path.join(mdir, f"{t:05d}.png.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    script = os.path.join(root, "stand_in_dm.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\n"
                f'exec cp {mdir}/$(basename "$1").txt "$6"\n')
    os.chmod(script, 0o755)
    return script


@pytest.mark.cuda
def test_para_gen_binary_matcher(card, tmp_path):
    """--matcher binary on 2 pairs of the para_gen tree with the stand-in
    matcher: the list file, the products and the flow gate; no ZNCC launch,
    the PCG kernel launched, no failed write."""
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    make_pipeline_tree(inp, n_frames=3)
    dm = _write_stand_in_matcher(str(tmp_path), inp, 2)
    zero_counts()
    lines = _para_gen(inp, out, matcher="binary", dm_bin=dm)
    check_pipeline_products(inp, out, lines, n_pairs=2)
    assert read_counts()["zncc_search"] == 0
    assert read_counts()["pcg_fixed"] > 0 and para_gen.WRITE_ERRORS == 0


@pytest.mark.cuda
@pytest.mark.parametrize("i,fam", list(enumerate(textures.FAMILIES)))
def test_texture_draws_are_jax(card, i, fam):
    """The values drawn from prng.key(80 + i) equal, bitwise, the ones the
    JAX package draws from jax.random.PRNGKey(80 + i); a 64x96 render's
    checksums on the card and on the CPU hold JAX's within the texture
    tolerance."""
    key = prng.key(80 + i)
    assert textures.draw_render_params(fam, TEX_H, TEX_W, key) == (
        TEX_JAX_DRAWS[fam])
    for where in (card, "cpu"):
        assert_texture_sums(textures.render(
            key, fam, 64, 96, device=where).cpu().numpy(), TEX_JAX_SUMS[fam])


TEX_CASES = [(i, fam, hw) for i, fam in enumerate(textures.FAMILIES)
             for hw in ((TEX_H, TEX_W), (120, 200))]


@pytest.mark.cuda
@pytest.mark.parametrize("i,fam,hw", TEX_CASES,
                         ids=[f"{f}-{h}x{w}" for _, f, (h, w) in TEX_CASES])
def test_texture_card_matches_cpu(card, i, fam, hw):
    """The same drawn values (from prng.key(80 + i) at 1280x720, from
    prng.key(21) at 200x120) on the card and on the CPU: fields within
    1e-4, uint8 images equal on ≥ 99.9% of values and elsewhere within
    1."""
    H, W = hw
    p = textures.draw_render_params(
        fam, H, W, prng.key(80 + i if hw == (TEX_H, TEX_W) else 21))
    f_err = (textures.field(fam, p["field"], H, W, card).cpu()
             - textures.field(fam, p["field"], H, W, "cpu")).abs().max()
    assert float(f_err) <= 1e-4
    d = np.abs(textures.render_params(fam, p, H, W, card).cpu().numpy()
               .astype(np.int16) - textures.render_params(fam, p, H, W,
                                                          "cpu").numpy())
    assert (d != 0).mean() <= 1e-3 and d.max() <= 1


def _check_dmo(masks: str, out: str, launches: dict) -> None:
    """The dual-set products, the flow against each object's motion
    (dmo_flow_gate) and the kernels' launches against the prediction."""
    z_exp = p_exp = 0
    mk = [load_mask(os.path.join(masks, "orgMasks", "seq0", f"{t:05d}.png"))
          for t in range(PIPE_FRAMES)]
    for fd in DMO_FDS:
        n_pairs = PIPE_FRAMES - fd
        s0, s1 = (os.path.join(out, s, f"fd{fd}") for s in ("set0", "set1"))
        with open(os.path.join(s0, "all_files.list")) as f:
            assert len(f.read().splitlines()) == n_pairs, fd
        for t in range(n_pairs):
            name = f"{t:05d}"
            for d, ext in (("Flow", "flo"), ("wMasks", "png")):
                a, b = (read_bytes(os.path.join(s, d, "seq0", f"{name}.{ext}"))
                        for s in (s0, s1))
                assert a == b, (fd, d, name)
            for d in ("inpRGB", "wRGB"):
                a, b = (load_rgb(os.path.join(s, d, "seq0", name + ".png"))
                        .astype(np.int16) for s in (s0, s1))
                assert np.abs(a - b).mean() > 2.0, (fd, d, name)
            u, v = flow_read(os.path.join(s0, "Flow", "seq0", name + ".flo"))
            for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
                obj = mk[t] == k + 1
                assert np.isfinite(u[obj]).all() and np.isfinite(v[obj]).all()
                err = float(np.median(np.hypot(u[obj] - fd * dx,
                                               v[obj] - fd * dy)))
                why = dmo_flow_gate(fd, t, k + 1, err)
                assert why is None, (fd, t, k + 1, why)
        z, p, _ = predicted_launches(os.path.join(out, "set0", "textured"),
                                     s0, SolverConfig(), masks=mk[:n_pairs])
        z_exp += z
        p_exp += p
    assert min(z_exp, p_exp) > 0
    assert (launches["zncc_search"], launches["pcg_fixed"]) == (z_exp, p_exp)


@pytest.mark.cuda
def test_dmo_gen(card, tmp_path):
    """dmo_gen.run on the para_gen tree's masks at fd 1 and 2 with two
    texture sets, batched and multseg at 19x8x400, cold and warm into fresh
    trees: set 0's and set 1's Flow and wMasks byte-identical, their inpRGB
    and wRGB different (mean |d| > 2), each object's median |flow − fd·t|
    held to the JAX package's own run of this tree, the launches of
    zncc_search and pcg_fixed as predicted, no failed write."""
    from arap_flow_tpu_torch.pipeline import dmo_gen

    masks = str(tmp_path / "masks")
    make_mask_tree(masks)
    for run in ("cold", "warm"):
        out = str(tmp_path / run)
        zero_counts()
        dmo_gen.run(masks, out, fds=list(DMO_FDS), multseg=True,
                    mode="batched", texture_sets=2, solver_cfg=SolverConfig(),
                    device="cuda")
        torch.cuda.synchronize()
        launches = read_counts()
        assert para_gen.WRITE_ERRORS == 0
        _check_dmo(masks, out, launches)


@pytest.mark.cuda
def test_subpatch_search(card):
    """The split-and-rescore search at the 854x480 frame's coarse shape
    (60x106, r = 13) on the card against the CPU: scores within 2e-4,
    offsets equal on ≥ 99% of pixels and elsewhere only on ties within
    2e-4, no zncc_search launch; then match_images(subpatch=True,
    rotations=(0.0,)) on an 854x480 pair translated by (6, -3): > 100
    matches, median within 0.5 px, > 80% within 1 px
    (tests/test_matching.py's gate), zncc_search launched once a refine
    level."""
    H, W, r = 60, 106, 13
    side = 2 * r + 1
    assert matching.subpatch_fits(H, W, r, 2)  # no rigid-search fallback
    p1, p2 = (torch.tensor(a[0]) for a in zncc_inputs(1, 1, H, W, r, 90))
    zero_counts()
    ku, kv, ks = (a.cpu() for a in matching._search_subpatch(
        p1.to(card), p2.to(card), r, 12, 2))
    assert read_counts()["zncc_search"] == 0
    pu, pv, ps = matching._search_subpatch(p1, p2, r, 12, 2)
    assert float((ks - ps).abs().max()) < 2e-4
    diff = (ku != pu) | (kv != pv)
    assert float(diff.float().mean()) <= 0.01
    if bool(diff.any()):
        idx = ((kv + r) * side + (ku + r)).to(torch.int64)
        at_card = torch.take_along_dim(matching.subpatch_scores(p1, p2, r, 12),
                                       idx[None], dim=0)[0]
        assert float((ps - at_card)[diff].max()) <= 2e-4

    dx, dy = 6, -3
    im1 = rgb_texture(FRAME_H, FRAME_W, 91)
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    zero_counts()
    m = matching.match_images(im1, im2, subpatch=True, rotations=(0.0,),
                              device=card)
    _, levels = matching.clamp_match_params(FRAME_H, FRAME_W)
    assert read_counts()["zncc_search"] == levels
    u, v = m[:, 2] - m[:, 0], m[:, 3] - m[:, 1]
    assert len(m) > 100
    assert abs(np.median(u) - dx) <= 0.5 and abs(np.median(v) - dy) <= 0.5
    assert ((np.abs(u - dx) <= 1) & (np.abs(v - dy) <= 1)).mean() > 0.8


@pytest.mark.cuda
def test_para_gen_warmup_fresh_process(tree, tmp_path):
    """para_gen --warmup in a fresh process on the para_gen tree: the
    prewarm reports its steps and the products are byte-identical to the
    batched run's."""
    inp, out = tree.inp, str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", "import sys\n"
         "from arap_flow_tpu_torch.pipeline import para_gen\n"
         "para_gen.main(sys.argv[1:])\n", "--input", inp, "--output", out,
         "--mode", "batched", "--multseg", "--seed", "0", "--warmup"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    warm = [ln for ln in proc.stdout.splitlines() if ln.startswith("warmup")]
    assert len(warm) >= 3, proc.stdout[-3000:]
    with open(os.path.join(out, "all_files.list")) as f:
        assert tree_digest(out, f.read().splitlines()) == tree.digest


@pytest.mark.cuda
def test_para_gen_sharded_on_one_card(tree, tmp_path):
    """para_gen --mode sharded on a mesh of the one card (the batched path):
    products byte-identical to --mode batched (the check of the JAX
    package's __graft_entry__.py:205); both kernels launched."""
    out = str(tmp_path / "out")
    zero_counts()
    lines = _para_gen(tree.inp, out, mode="sharded", device="cuda:0")
    assert tree_digest(out, lines) == tree.digest
    assert read_counts()["pcg_fixed"] > 0 and read_counts()["zncc_search"] > 0


def _cli(*argv) -> int:
    """One command of ``python -m arap_flow_tpu_torch``, in this process."""
    from arap_flow_tpu_torch.__main__ import main as tool_main

    rc = tool_main([str(a) for a in argv])
    torch.cuda.synchronize()
    return rc


def _median_motion_error(u, v, sel, motion) -> float:
    dx, dy = motion
    return float(np.median(np.hypot(u[sel] - dx, v[sel] - dy)))


@pytest.mark.cuda
def test_generate(tree, tmp_path):
    """generate --phases match convert deform bg on the para_gen tree
    (generate solves each frame whole): every product and list line
    written, each object's median |flow − t| < 1 px, the median |flow − the
    batched run's flow| over the objects < 0.05 px, one matcher call and
    152 PCG calls a pair."""
    from arap_flow_tpu_torch.ops.matching import clamp_match_params, zncc_calls

    inp, ref = tree.inp, tree.out
    out = str(tmp_path / "generate")
    zero_counts()
    assert _cli("generate", "--input", inp, "--output", out, "--phases",
                "match", "convert", "deform", "bg") == 0
    cfg = SolverConfig()
    assert (read_counts()["zncc_search"], read_counts()["pcg_fixed"]) == (
        N_PAIRS * zncc_calls(clamp_match_params(FRAME_H, FRAME_W)[1]),
        N_PAIRS * cfg.num_anneal * cfg.gn_iters)
    with open(os.path.join(out, "all_files.list")) as f:
        assert len(f.read().splitlines()) == N_PAIRS
    for t in range(N_PAIRS):
        name = f"{t:05d}"
        for d, ext in (("Flow", "flo"), ("inpRGB", "png"),
                       ("inpMasks", "png"), ("wRGB", "png"),
                       ("wMasks", "png"), ("tmpCnstr", "txt")):
            assert os.path.exists(os.path.join(out, d, "seq0",
                                               f"{name}.{ext}")), (d, name)
        mk = load_mask(os.path.join(inp, "orgMasks", "seq0", name + ".png"))
        u, v = flow_read(os.path.join(out, "Flow", "seq0", name + ".flo"))
        ru, rv = flow_read(os.path.join(ref, "Flow", "seq0", name + ".flo"))
        for k, (_, _, motion) in enumerate(PIPE_OBJECTS):
            assert _median_motion_error(u, v, mk == k + 1, motion) < 1.0
        obj = mk != 0
        assert float(np.median(np.hypot(u[obj] - ru[obj],
                                        v[obj] - rv[obj]))) < 0.05


# An MPI-Sintel-style tree at 1024x436: 2 frames a pass, two textured
# ellipses (one 230x940, wider than any crop bucket) moving by their
# translations, a constraint every 8 px inside each.
SINTEL_SEQ = "alley_1"
SINTEL_PASSES = ("clean", "final")
SINTEL_FRAMES = 2  # frames a pass
SINTEL_OBJECTS = (  # (centre y, x), (radius y, x), (dx, dy) a frame
    ((140, 512), (115, 470), (7, -4)),  # a 230x940 box: wider than any bucket
    ((350, 300), (60, 100), (-6, 5)),
)


def _sintel_path(root: str, kind: str, pas: str, i: int, ext: str) -> str:
    base = root if kind == "frames" else os.path.join(root, kind)
    return os.path.join(base, pas, SINTEL_SEQ, f"frame_{i:04d}.{ext}")


def _make_sintel_tree(root: str) -> None:
    """ROOT/{clean,final}/SEQ/frame_XXXX.png, the ARAP masks ROOT/masks/
    {pass}/SEQ/frame_XXXX.png (0 on the two objects, 255 elsewhere) and
    ROOT/cnstr/{pass}/SEQ/frame_XXXX.txt. The final pass is the clean one
    darkened, with noise."""
    H, W = SINTEL_H, SINTEL_W
    texs = [rgb_texture(H, W, 40 + k) for k in range(len(SINTEL_OBJECTS))]
    bg = rgb_texture(H, W, 50) // 3
    yy, xx = np.mgrid[0:H, 0:W]
    ys, xs = np.mgrid[0:H:8, 0:W:8]
    rng = np.random.default_rng(51)
    for i in range(1, SINTEL_FRAMES + 1):
        img = bg.copy()
        mask = np.full((H, W), 255, np.uint8)
        cons = []
        for k, ((cy, cx), (ry, rx), (dx, dy)) in enumerate(SINTEL_OBJECTS):
            cy, cx = cy + dy * (i - 1), cx + dx * (i - 1)
            ob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            img[ob] = texs[k][(yy[ob] - dy * (i - 1)) % H,
                              (xx[ob] - dx * (i - 1)) % W]
            mask[ob] = 0
            inner = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 0.8
            cons += [(x, y, x + dx, y + dy)
                     for y, x in zip(ys[inner], xs[inner])]
        final = np.clip(img * 0.8 + rng.normal(0, 4, img.shape), 0,
                        255).astype(np.uint8)
        for pas, frame in zip(SINTEL_PASSES, (img, final)):
            for kind, arr in (("frames", frame), ("masks", mask)):
                path = _sintel_path(root, kind, pas, i, "png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_image(path, arr)
            path = _sintel_path(root, "cnstr", pas, i, "txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_constraint_file(path, np.array(cons, np.int32))


@pytest.fixture(scope="module")
def sintel(card, tmp_path_factory):
    """The Sintel-style tree and ``run_arap --input ROOT --passes clean
    final`` on it (each frame solved whole, the 4 frames as one batch):
    (root, exit code, launches)."""
    root = str(tmp_path_factory.mktemp("sintel"))
    _make_sintel_tree(root)
    zero_counts()
    rc = _cli("run_arap", "--input", root, "--passes", *SINTEL_PASSES)
    return root, rc, read_counts()


@pytest.mark.cuda
def test_run_arap(sintel):
    """run_arap --input, then the same jobs through run_arap --list: both
    exit 0, their products byte-identical, each object's median |flow − t|
    < 1 px, pcg_fixed launched."""
    root, rc, launches = sintel
    assert rc == 0 and launches["pcg_fixed"] > 0
    jobs, lines = [], []
    for pas in SINTEL_PASSES:
        for i in range(1, SINTEL_FRAMES + 1):
            ins = [_sintel_path(root, k, pas, i, e) for k, e in (
                ("frames", "png"), ("masks", "png"), ("cnstr", "txt"))]
            outs = []
            for d in ("flow_arap", "list_out"):
                stem = os.path.join(root, d, pas, SINTEL_SEQ,
                                    f"frame_{i:04d}")
                outs.append([stem + ".flo", stem + "_wRGB.png",
                             stem + "_wMask.png"])
            os.makedirs(os.path.dirname(outs[1][0]), exist_ok=True)
            jobs.append((ins, outs, i))
            lines.append(" ".join(ins + outs[1]))
    listfile = os.path.join(root, "jobs.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert _cli("run_arap", "--list", listfile) == 0
    yy, xx = np.mgrid[0:SINTEL_H, 0:SINTEL_W]
    for (_, mask, _), (o1, o2), i in jobs:
        assert all(read_bytes(a) == read_bytes(b) for a, b in zip(o1, o2))
        u, v = flow_read(o1[0])
        obj = load_mask(mask) == 0
        for (cy, cx), (ry, rx), (dx, dy) in SINTEL_OBJECTS:
            cy, cx = cy + dy * (i - 1), cx + dx * (i - 1)
            sel = obj & (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0)
            assert _median_motion_error(u, v, sel, (dx, dy)) < 1.0


@pytest.mark.cuda
def test_run_warp(tree, tmp_path):
    """run_warp --backend device and --backend host over the para_gen run's
    output tree (as ROOT/fd1): every product bitwise warp_tool.warp_image's
    on the same files, the two backends' wMasks agreeing on ≥ 98% of the
    pixels."""
    from arap_flow_tpu_torch.pipeline.run_warp import scan_jobs
    from arap_flow_tpu_torch.pipeline.warp_tool import warp_image

    root = str(tmp_path / "warp")
    shutil.copytree(tree.out, os.path.join(root, "fd1"))
    jobs = scan_jobs(root, [1])
    assert len(jobs) == N_PAIRS
    masks = {}
    for backend in ("device", "host"):
        assert _cli("run_warp", "--root", root, "--fd", 1, "--backend",
                    backend) == 0
        for j, (rgb, msk, flo, wrgb, wmsk) in enumerate(jobs):
            ref = [str(tmp_path / f"{backend}{j}_{n}.png") for n in "wm"]
            warp_image(rgb, msk, flo, *ref,
                       device=torch.device("cuda", 0)
                       if backend == "device" else None, backend=backend)
            assert read_bytes(wrgb) == read_bytes(ref[0])
            assert read_bytes(wmsk) == read_bytes(ref[1])
            masks.setdefault(backend, []).append(load_mask(wmsk))
    assert min(float((a == b).mean()) for a, b in zip(masks["device"],
                                                       masks["host"])) >= 0.98


@pytest.mark.cuda
def test_warp_cli_subprocess(sintel, tmp_path):
    """python3 -m arap_flow_tpu_torch warp in a subprocess on the first
    clean Sintel frame and its run_arap flow: bitwise the in-process
    warp_image's on the same files."""
    from arap_flow_tpu_torch.pipeline.warp_tool import warp_image

    root = sintel[0]
    args = [_sintel_path(root, "frames", "clean", 1, "png"),
            _sintel_path(root, "masks", "clean", 1, "png"),
            os.path.join(root, "flow_arap", "clean", SINTEL_SEQ,
                         "frame_0001.flo")]
    outs = [str(tmp_path / n) for n in ("sub_w.png", "sub_m.png",
                                        "in_w.png", "in_m.png")]
    proc = subprocess.run(
        [sys.executable, "-m", "arap_flow_tpu_torch", "warp", *args,
         *outs[:2]], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    warp_image(*args, *outs[2:], device=torch.device("cuda", 0))
    assert read_bytes(outs[0]) == read_bytes(outs[2])
    assert read_bytes(outs[1]) == read_bytes(outs[3])


@pytest.mark.cuda
def test_texture_gen(card, tmp_path):
    """texture_gen --num 7 --seed TEXGEN_SEED --size 1280 720: 7 files, the
    first one's family JAX's and its 64x96 render's checksums JAX's within
    the texture tolerance, the file bitwise the card's render of its
    key."""
    out = str(tmp_path / "textures")
    assert _cli("texture_gen", "--output", out, "--num", 7, "--seed",
                TEXGEN_SEED, "--size", 1280, 720) == 0
    files = sorted(os.listdir(out))
    fam, want = TEXGEN_JAX_FIRST
    assert len(files) == 7 and files[0].endswith(f"_{fam}.png"), files
    key = prng.key(TEXGEN_SEED * 100003)
    assert_texture_sums(textures.render(key, fam, 64, 96, device=card)
                        .cpu().numpy(), want)
    assert np.array_equal(load_rgb(os.path.join(out, files[0])),
                          textures.render(key, fam, 720, 1280,
                                          device=card).cpu().numpy())


@pytest.mark.cuda
def test_zncc_at_the_sintel_shapes(sintel, monkeypatch):
    """The matcher on a sub-batch of 4 Sintel-shaped pairs (the tree's
    frames) makes 4 searches, the last at the full frame; at each of their
    shapes the kernel against its plain version, as the matcher's own
    shapes are checked."""
    from arap_flow_tpu_torch.ops.zncc import zncc_search

    dev = torch.device("cuda", 0)
    frames = {(p, i): load_rgb(_sintel_path(sintel[0], "frames", p, i, "png"))
              for p in SINTEL_PASSES for i in (1, 2)}
    pairs = [(frames[(p, 1)], frames[(p, 2)]) for p in SINTEL_PASSES]
    pairs += [(b, a) for a, b in pairs]
    shapes = []

    def recorder(p1, p2, radius, *a, **k):
        shapes.append((p1.shape[0] if p1.dim() == 3 else 1,
                       p2.shape[0] if p2.dim() == 3 else 1,
                       *p1.shape[-2:], int(radius)))
        return zncc_search(p1, p2, radius, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(matching, "zncc_search", recorder)
        for h in matching.match_images_dispatch_multi(pairs, radius=100,
                                                      device=dev):
            matching.match_images_fetch(h)
    assert len(shapes) == 4 and shapes[-1][2:4] == (SINTEL_H, SINTEL_W)
    for N1, N2, H, W, r in shapes:
        a, b = zncc_inputs(N1, N2, H, W, r, seed=H + W + r)
        assert_zncc_matches_plain(torch.as_tensor(a, device=dev),
                                  torch.as_tensor(b, device=dev), r)


@pytest.mark.cuda
def test_endurance_cut(card):
    """tools/endurance.py in this process at --pairs 48 --block 4 (its warm
    cycle of one size cycle, 48 pairs, then 48 measured pairs), 19x8x400:
    the tool's gates (flow checks on the in-block pairs, no build during the
    measured run, no PCG shape the warm cycle did not solve, RSS and
    memory_reserved not growing) with at most 2 of 48 pairs dropped; both
    kernels launched."""
    from arap_flow_tpu_torch.tools import endurance

    zero_counts()
    result = endurance.run(48, 4, endurance.DEFAULT_SCHEDULE, "cuda")
    assert endurance.failures(result, max_dropped=2) == []
    assert read_counts()["pcg_fixed"] > 0 and read_counts()["zncc_search"] > 0
