"""The port on the dryrun's mini dataset, and on a JPEG tree with --size
and --bg_dir where PIL and jax cannot be imported.

Dryrun parity: ``__graft_entry__._make_mini_dataset``'s tree (copied here:
importing ``__graft_entry__`` sets up its JAX entry): 96×160, 3 JPEG
frames at quality 98 written by PIL, one moving box. The JAX
``para_gen --mode batched`` (single device; its XLA PCG, which
tests/test_pallas_pcg.py holds to the dryrun's Pallas kernel) and the
port's ``--mode batched --device cpu`` run the dryrun's 2×2×40 schedule;
the port decodes the JPEGs with its own decoder. The port's flows are
within 0.05 px of JAX's over the object, the list file, the constraint
files and the inpMasks pixels are the same (the two packages' PNG
encoders differ), and the wMasks agree on all but < 0.1% of pixels. Both match on a 2×-pooled image
(``match_downscale=2``) to keep the CPU matcher cheap; ``--mode sharded``
is not compared (it and ``--mode batched`` differ on this host; ROADMAP,
queue 3).
"""

import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
from PIL import Image

from arap_flow_tpu.io import flo as JF
from arap_flow_tpu.io.image import load_mask
from arap_flow_tpu.ops.solver import SolverConfig as JConfig
from arap_flow_tpu.pipeline import para_gen as JP
from arap_flow_tpu_torch.ops.solver import SolverConfig as TConfig
from arap_flow_tpu_torch.pipeline import para_gen as TP

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
DRYRUN = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)


def _make_mini_dataset(root, H=96, W=160, n_frames=3):
    """__graft_entry__._make_mini_dataset, unchanged."""
    rng = np.random.default_rng(1)
    tex = np.kron(rng.uniform(60, 255, (H // 8 + 2, W // 8 + 2, 3)),
                  np.ones((8, 8, 1)))[:H, :W].astype(np.uint8)
    bg = (tex[::-1, ::-1] // 3).copy()
    os.makedirs(osp.join(root, "orgRGB", "seq0"), exist_ok=True)
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        y0, x0 = 20 + 2 * t, 30 + 3 * t
        ob = (yy >= y0) & (yy < y0 + 34) & (xx >= x0) & (xx < x0 + 40)
        img[ob] = tex[yy[ob] - 2 * t, xx[ob] - 3 * t]
        mask[ob] = 1
        Image.fromarray(img).save(
            osp.join(root, "orgRGB", "seq0", f"{t:05d}.jpg"), quality=98
        )
        Image.fromarray(mask).save(
            osp.join(root, "orgMasks", "seq0", f"{t:05d}.png")
        )


def _rel_lines(lines, out):
    return [[osp.relpath(p, out) for p in line.split(" ")] for line in lines]


def test_dryrun_mini_dataset_parity(tmp_path):
    inp = str(tmp_path / "data")
    _make_mini_dataset(inp)
    jo, to = str(tmp_path / "jax"), str(tmp_path / "port")
    jl = JP.main_pipeline(
        JP.PipelineFlags(input=inp, output=jo, fd=1, seed=0, mode="batched",
                         match_downscale=2),
        solver_cfg=JConfig(**DRYRUN, backend="xla"))
    tl = TP.main_pipeline(
        TP.PipelineFlags(input=inp, output=to, fd=1, seed=0, mode="batched",
                         match_downscale=2, device="cpu"),
        solver_cfg=TConfig(**DRYRUN))
    assert len(jl) == 2 and _rel_lines(tl, to) == _rel_lines(jl, jo)
    for t in range(2):
        name = f"{t:05d}"
        tu, tv = JF.flow_read(osp.join(to, "Flow", "seq0", name + ".flo"))
        ju, jv = JF.flow_read(osp.join(jo, "Flow", "seq0", name + ".flo"))
        obj = load_mask(osp.join(inp, "orgMasks", "seq0", name + ".png")) != 0
        assert np.abs(tu - ju)[obj].max() < 0.05
        assert np.abs(tv - jv)[obj].max() < 0.05
        assert abs(np.median(tu[obj]) - 3) < 0.5
        assert abs(np.median(tv[obj]) - 2) < 0.5
        masks = {sub: [load_mask(osp.join(o, sub, "seq0", name + ".png"))
                       for o in (to, jo)] for sub in ("inpMasks", "wMasks")}
        np.testing.assert_array_equal(*masks["inpMasks"])
        # given the same warp the two rasterizers' masks are equal, and each
        # equals the float64 coverage test on its own warp; the warps differ
        # by up to 1.5e-3 px (float32 CG's summation order), which flips 4
        # boundary pixels of 15,360
        tw, jw = masks["wMasks"]
        assert (tw != jw).mean() < 1e-3 and (tw > 0).sum() > 1000
        cstr = osp.join("tmpCnstr", "seq0", name + ".txt")
        with open(osp.join(to, cstr), "rb") as a, \
                open(osp.join(jo, cstr), "rb") as b:
            assert a.read() == b.read()


def test_jpeg_tree_with_size_and_backgrounds_needs_no_pil_nor_jax(tmp_path):
    """para_gen on JPEG frames with --size and a JPEG --bg_dir, in a
    subprocess where importing PIL, jax, arap_flow_tpu or bench fails."""
    from arap_flow_tpu_torch.io.image import save_image

    inp = tmp_path / "data"
    _make_mini_dataset(str(inp))
    os.makedirs(inp / "bg")
    rng = np.random.default_rng(2)
    for i in range(2):
        save_image(inp / "bg" / f"b{i}.jpg",
                   rng.integers(0, 255, (60 + 7 * i, 100, 3)).astype(np.uint8))
    out = tmp_path / "out"
    code = textwrap.dedent(f"""
        import sys
        for name in ("PIL", "jax", "arap_flow_tpu", "bench"):
            sys.modules[name] = None  # any import of them raises
        from arap_flow_tpu_torch.ops.solver import SolverConfig
        from arap_flow_tpu_torch.pipeline import para_gen as P
        flags = P.PipelineFlags(input={str(inp)!r}, output={str(out)!r},
                                seed=0, mode="batched", size=(120, 72),
                                bg_dir={str(inp / "bg")!r}, device="cpu",
                                match_downscale=2)
        lines = P.main_pipeline(flags, solver_cfg=SolverConfig(
            num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0))
        loaded = [m for m, v in sys.modules.items() if v is not None and
                  m.split(".")[0] in ("PIL", "jax", "arap_flow_tpu")]
        print("LINES", len(lines), "LOADED", loaded)
    """)
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LINES 2 LOADED []" in proc.stdout, proc.stdout[-2000:]
    from arap_flow_tpu_torch.io.image import load_rgb

    rgb = load_rgb(out / "inpRGB" / "seq0" / "00000.png")
    assert rgb.shape == (72, 120, 3)
    mask = load_mask(out / "inpMasks" / "seq0" / "00000.png")
    assert (rgb[mask != 0] > 0).any()  # backgrounds composited
