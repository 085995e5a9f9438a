"""The port's deform slice as a whole agrees with the JAX package's: the
batched canvas solve/raster (plain and transposed), ArapDeformer in simple,
crop and keep_state modes, BatchRunner, and the deform / warp CLIs, all at a
short schedule (2 anneal × 2 GN × 40 PCG).

Tolerances: flows within 0.05 px (the full-solve bound of
tests/test_pallas_pcg.py:59; both solvers run float32 with different
summation orders); i16 flows are compared after dequantisation, whose
1/64 px quantum is inside that bound. Warped masks may disagree on at most
0.5 % of pixels: a flow difference of a few 1e-3 px can flip a coverage test
on a triangle edge. Warped colours are not compared for equality for the
same reason (a truncation to uint8 moves with the barycentric weights).
"""

import numpy as np
import pytest
import torch

from arap_flow_tpu.io import flo as JF
from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.io.image import save_image
from arap_flow_tpu.models import arap as JA
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops.solver import SolverConfig as JConfig
from arap_flow_tpu.pipeline import batch as JB
from arap_flow_tpu.pipeline import deform_tool as JD
from arap_flow_tpu.pipeline import warp_tool as JW
from arap_flow_tpu.utils.config import FrameworkConfig as JFramework
from arap_flow_tpu_torch import __main__ as TMain
from arap_flow_tpu_torch.io import flo as TF
from arap_flow_tpu_torch.io.image import load_mask, load_rgb
from arap_flow_tpu_torch.models import arap as TA
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops.solver import SolverConfig as TConfig
from arap_flow_tpu_torch.pipeline import batch as TB
from arap_flow_tpu_torch.pipeline import deform_tool as TD
from arap_flow_tpu_torch.pipeline import warp_tool as TW
from arap_flow_tpu_torch.utils.config import FrameworkConfig, cli_device
from arap_flow_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

SHORT = dict(num_anneal=2, gn_iters=2, max_pcg_iters=40, pcg_iters=40.0)
FLOW_TOL = 0.05
MASK_TOL = 0.005
BUCKETS = ((32, 32), (32, 48), (48, 32), (48, 48), (48, 64), (64, 64),
           (64, 96))


def _frame(H=56, W=72, seed=0, box=(18, 38, 20, 44), disp=(2, 3)):
    rng = np.random.default_rng(seed)
    mask = np.full((H, W), 255, np.uint8)
    y0, y1, x0, x1 = box
    mask[y0:y1, x0:x1] = 0
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[y0 + 2 : y1 - 1 : 4, x0 + 2 : x1 - 1 : 4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + disp[1],
                     ys.ravel() + disp[0]], 1).astype(np.int32)
    cons[::3, 2] += 1  # a little non-rigid
    return rgb, mask, cons


def _assert_products_close(t, j):
    """Flow within FLOW_TOL px; warped mask disagreement within MASK_TOL."""
    assert t.flow.shape == j.flow.shape and t.flow.dtype == np.float32
    assert np.abs(t.flow - j.flow).max() < FLOW_TOL
    assert t.warped_rgb.dtype == np.uint8 and t.warped_rgb.shape == j.warped_rgb.shape
    assert (t.warped_mask != j.warped_mask).mean() <= MASK_TOL
    assert (j.warped_mask > 0).sum() > 100


def _canvas_inputs(transposed: bool):
    """Two problems on a (48, 64) canvas: (solve ops, rgb, offs)."""
    items, rgbs = [], []
    for k, box in enumerate(((6, 26, 8, 40), (8, 28, 4, 38))):
        rgb, mask, cons = _frame(32, 44, seed=k, box=box, disp=(1 + k, -2))
        if transposed:
            mask, cons = np.ascontiguousarray(mask.T), cons[:, [1, 0, 3, 2]]
        items.append(JE.build_compact(mask, add_border_pins(
            cons, mask.shape[1], mask.shape[0])))
        rgbs.append(np.ascontiguousarray(rgb.transpose(2, 0, 1)))
    offs = np.asarray([[4, 6], [16, 20]], np.int32)
    return items, np.stack(rgbs), offs


@pytest.mark.parametrize("transposed", [False, True])
def test_solve_and_raster_canvas_matches_jax(transposed):
    items, rgb, offs = _canvas_inputs(transposed)
    jops = JE.CompactOperands(*(np.stack(ls) for ls in zip(*items)))
    jf, jr, jm = JA.solve_and_raster_canvas(
        jops, rgb, offs, JConfig(**SHORT), canvas_hw=(48, 64),
        transposed=transposed)
    tops = TE.CompactOperands.stack(
        [TE.CompactOperands(*it) for it in items]).to("cpu")
    tf, tr, tm = TA.solve_and_raster_canvas(
        tops, torch.as_tensor(rgb), offs, TConfig(**SHORT), canvas_hw=(48, 64),
        transposed=transposed)
    assert tf.dtype == torch.int16 and tuple(tf.shape) == np.asarray(jf).shape
    assert tr.dtype == torch.uint8 and tuple(tr.shape) == (2, 3, 48, 64)
    dflow = np.abs(tf.numpy().astype(np.float32) - np.asarray(jf)) / 64.0
    assert dflow.max() < FLOW_TOL
    jm = np.asarray(jm)
    assert (tm.numpy() != jm).mean() <= MASK_TOL
    assert (jm > 0).sum() > 400


def test_solve_and_raster_batch_matches_jax():
    frames = [_frame(seed=s) for s in (3, 4)]
    items = [JE.build_compact(m, add_border_pins(c, 72, 56))
             for _, m, c in frames]
    rgb = np.stack([np.ascontiguousarray(r.transpose(2, 0, 1))
                    for r, _, _ in frames])
    jops = JE.CompactOperands(*(np.stack(ls) for ls in zip(*items)))
    _, jf, _, jm = JA.solve_and_raster_batch(jops, rgb, JConfig(**SHORT),
                                             compact_flow=True)
    tops = TE.CompactOperands.stack(
        [TE.CompactOperands(*it) for it in items]).to("cpu")
    x, tf, _, tm = TA.solve_and_raster_batch(tops, torch.as_tensor(rgb),
                                             TConfig(**SHORT), compact_flow=True)
    assert tuple(x.shape) == (2, 3, 56, 72)
    assert np.abs(tf.numpy() / 64.0 - np.asarray(jf) / 64.0).max() < FLOW_TOL
    assert (tm.numpy() != np.asarray(jm)).mean() <= MASK_TOL


@pytest.mark.parametrize("mode", ["simple", "crop", "keep_state"])
def test_deformer_matches_jax(mode):
    rgb, mask, cons = _frame(seed=5)
    kw = dict(crop=mode == "crop", keep_state=mode == "keep_state",
              crop_buckets=BUCKETS)
    j = JA.ArapDeformer(JConfig(**SHORT), **kw).deform(rgb, mask, cons)
    t = TA.ArapDeformer(TConfig(**SHORT), device="cpu", **kw).deform(
        rgb, mask, cons)
    _assert_products_close(t, j)
    if mode == "keep_state":
        assert np.abs(t.state - j.state).max() < FLOW_TOL
    else:
        assert t.state is None


def test_deformer_crop_solves_transposed_and_falls_back():
    """A wide object takes a transposed bucket; an object no bucket fits
    solves full-frame. Both agree with the JAX deformer."""
    wide = _frame(64, 96, seed=6, box=(24, 34, 8, 62), disp=(1, 2))
    big = _frame(seed=7, box=(2, 54, 2, 70), disp=(1, 1))
    buckets = ((64, 32), (48, 96), (96, 32))
    rgb, mask, cons = wide
    task = TB.make_task(0, 0, rgb, mask, cons, TE.ArapWeights(),
                        buckets=buckets)
    assert task is not None and task.transposed
    assert TB.make_task(0, 0, *big, TE.ArapWeights(), buckets=buckets) is None
    for fr in (wide, big):
        j = JA.ArapDeformer(JConfig(**SHORT), crop=True,
                            crop_buckets=buckets).deform(*fr)
        t = TA.ArapDeformer(TConfig(**SHORT), crop=True, crop_buckets=buckets,
                            device="cpu").deform(*fr)
        _assert_products_close(t, j)


def test_deformer_solve_flow_and_options():
    rgb, mask, cons = _frame(seed=8)
    j = JA.ArapDeformer(JConfig(**SHORT)).solve_flow(mask, cons)
    t = TA.ArapDeformer(TConfig(**SHORT), device="cpu").solve_flow(mask, cons)
    assert np.abs(t - j).max() < FLOW_TOL
    with pytest.raises(ValueError):
        TA.ArapDeformer(keep_state=True, crop=True, device="cpu")
    with pytest.raises(ValueError):
        TA.ArapDeformer(raster="nope", device="cpu")
    host = TA.ArapDeformer(TConfig(**SHORT), raster="host", keep_state=True,
                           device="cpu").deform(rgb, mask, cons)
    jhost = JA.ArapDeformer(JConfig(**SHORT), raster="host",
                            keep_state=True).deform(rgb, mask, cons)
    assert np.abs(host.flow - jhost.flow).max() < FLOW_TOL
    assert host.state is not None and host.state.shape == (3, 56, 72)
    assert (host.warped_mask != jhost.warped_mask).mean() <= MASK_TOL
    r = TA.deform(rgb, mask, cons, TConfig(**SHORT), device="cpu")
    assert r.flow.shape == (56, 72, 2)


def test_batch_runner_matches_jax():
    """Two tasks of one bucket (one chunk of 2), one of another, and a
    full-frame fallback, through both runners."""
    probs = [
        _frame(seed=9, box=(10, 30, 10, 40)),
        _frame(seed=10, box=(20, 40, 24, 54), disp=(-2, 1)),
        _frame(seed=11, box=(8, 40, 6, 64), disp=(1, -1)),
        _frame(seed=12, box=(2, 54, 2, 70)),
    ]
    timer = StageTimer()
    jr = JB.BatchRunner(JConfig(**SHORT))
    tr = TB.BatchRunner(TConfig(**SHORT), device="cpu", timer=timer)
    keys = set()
    for i, (rgb, mask, cons) in enumerate(probs):
        jt = JB.make_task(i, 0, rgb, mask, cons, JE.ArapWeights(),
                          buckets=BUCKETS)
        tt = TB.make_task(i, 0, rgb, mask, cons, TE.ArapWeights(),
                          buckets=BUCKETS)
        assert (jt is None) == (tt is None)
        if tt is None:
            jr.add_fallback(i, 0, rgb, mask, cons)
            tr.add_fallback(i, 0, rgb, mask, cons)
        else:
            keys.add((tt.bucket, tt.canvas, tt.transposed))
            jr.add(jt)
            tr.add(tt)
    assert len(keys) == 2  # the first two tasks share a chunk
    jout, tout = jr.finish(), tr.finish()
    assert sorted(tout) == sorted(jout) == [(i, 0) for i in range(4)]
    for k in jout:
        _assert_products_close(tout[k], jout[k])
    assert {"upload+stack", "D2H fetch", "host paste"} <= set(timer.totals)
    assert "D2H fetch" in timer.report()


def _write_tree(root, n=2, H=40, W=56):
    """n frames of one size: rgb/mask PNGs + constraint files, and a list
    file naming their outputs."""
    lines = []
    for i in range(n):
        rgb, mask, cons = _frame(H, W, seed=20 + i, box=(10, 30, 12, 44),
                                 disp=(1 + i, 2))
        paths = {k: root / f"{k}{i}.{ext}" for k, ext in (
            ("rgb", "png"), ("mask", "png"), ("cstr", "txt"))}
        save_image(paths["rgb"], rgb)
        save_image(paths["mask"], mask)
        with open(paths["cstr"], "w") as f:
            f.write(f"{len(cons)}\n" + "\n".join(
                " ".join(str(v) for v in row) for row in cons))
        lines.append([str(paths["rgb"]), str(paths["mask"]), str(paths["cstr"])])
    return lines


def _run_both_cli(tmp_path, monkeypatch, frames, as_list: bool):
    monkeypatch.setattr(JD, "make_config", lambda s: JConfig(**SHORT))
    monkeypatch.setattr(TD, "make_config", lambda s: TConfig(**SHORT))
    outs = {}
    for tag, mod, extra in (("j", JD, []), ("t", TD, ["--device", "cpu"])):
        rows = [r + [str(tmp_path / f"{tag}{i}.{e}") for e in (
            "flo", "w.png", "m.png")] for i, r in enumerate(frames)]
        if as_list:
            lst = tmp_path / f"{tag}.txt"
            lst.write_text("\n".join(" ".join(r) for r in rows) + "\n")
            mod.main([str(lst), *extra])
        else:
            mod.main([*rows[0], *extra])
        outs[tag] = rows
    return outs


@pytest.mark.parametrize("as_list", [False, True])
def test_deform_tool_cli_matches_jax(tmp_path, monkeypatch, as_list):
    frames = _write_tree(tmp_path, n=2 if as_list else 1)
    outs = _run_both_cli(tmp_path, monkeypatch, frames, as_list)
    for jrow, trow in zip(outs["j"], outs["t"]):
        ju, jv = JF.flow_read(jrow[3])
        tu, tv = TF.flow_read(trow[3])
        assert max(np.abs(tu - ju).max(), np.abs(tv - jv).max()) < FLOW_TOL
        jm, tm = load_mask(jrow[5]), load_mask(trow[5])
        assert (jm != tm).mean() <= MASK_TOL and (jm > 0).sum() > 100
        assert load_rgb(trow[4]).shape == load_rgb(jrow[4]).shape


def test_warp_tool_cli_matches_jax(tmp_path):
    rgb, mask, _ = _frame(seed=30)
    save_image(tmp_path / "i.png", rgb)
    save_image(tmp_path / "m.png", mask)
    yy, xx = np.mgrid[0:56, 0:72].astype(np.float32)
    flow = np.dstack([2 + np.sin(yy / 6), -1 + np.cos(xx / 5)]).astype(np.float32)
    JF.flow_write(tmp_path / "f.flo", flow)
    JW.main([str(tmp_path / p) for p in ("i.png", "m.png", "f.flo", "jw.png",
                                         "jm.png")] + ["--backend", "device"])
    TW.main([str(tmp_path / p) for p in ("i.png", "m.png", "f.flo", "tw.png",
                                         "tm.png")]
            + ["--backend", "device", "--device", "cpu"])
    for j, t in (("jw.png", "tw.png"), ("jm.png", "tm.png")):
        np.testing.assert_array_equal(load_rgb(tmp_path / t),
                                      load_rgb(tmp_path / j))
    # the exact host splat (the JAX tool's default), bitwise
    JW.main([str(tmp_path / p) for p in ("i.png", "m.png", "f.flo", "jh.png",
                                         "jhm.png")] + ["--backend", "host"])
    TW.main([str(tmp_path / p) for p in ("i.png", "m.png", "f.flo", "th.png",
                                         "thm.png")] + ["--backend", "host"])
    for j, t in (("jh.png", "th.png"), ("jhm.png", "thm.png")):
        np.testing.assert_array_equal(load_rgb(tmp_path / t),
                                      load_rgb(tmp_path / j))
    with pytest.raises(ValueError):
        TW.warp_image(*(tmp_path / p for p in ("i.png", "m.png", "f.flo",
                                               "a.png", "b.png")),
                      device="cpu", backend="nope")
    if not torch.cuda.is_available():  # the default is the card's rasterizer
        with pytest.raises(SystemExit, match="CUDA is not available"):
            TW.main([str(tmp_path / p) for p in ("i.png", "m.png", "f.flo",
                                                 "a.png", "b.png")])


def test_main_dispatch(capsys):
    assert TMain.main(["--help"]) == 0
    assert TMain.main(["nope"]) == 1
    assert "deform" in capsys.readouterr().out


def test_cli_device_is_explicit():
    assert cli_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert cli_device("cuda").type == "cuda"
    else:
        with pytest.raises(SystemExit):
            cli_device("cuda")


def test_framework_config_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("ARAP_SCHEDULE", "fast")
    monkeypatch.setenv("ARAP_RASTER", "host")
    monkeypatch.setenv("ARAP_W_FIT", "50")
    monkeypatch.setenv("ARAP_MATCHER", "file")
    t = FrameworkConfig.from_env(solver=TD.make_config("parity"))
    j = JFramework.from_env(solver=JD.make_config("parity"))
    assert t.weights == tuple(j.weights)
    assert (t.raster, t.matcher) == (j.raster, j.matcher)
    for f in ("pcg_iters_early", "anneal_split", "q_tolerance"):
        assert getattr(t.solver, f) == getattr(j.solver, f)
    monkeypatch.setenv("ARAP_BACKEND", "cuda")
    assert FrameworkConfig.from_env().solver.backend == "cuda"
    monkeypatch.setenv("ARAP_BACKEND", "pallas")  # a JAX name: ignored
    assert FrameworkConfig.from_env().solver.backend == "auto"
    assert TD.make_config("fast").q_tolerance == 1e-4


def test_run_tasks_fallback_respects_weights():
    """tests/test_pipeline_batched.py's test_fallback_respects_weights: an
    oversized segment (no bucket fits) falls back to a full-frame solve
    inside run_tasks, with the caller's weights, not the defaults."""
    Hs, Ws = 48, 64
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (Hs, Ws, 3)).astype(np.uint8)
    mask = np.full((Hs, Ws), 255, np.uint8)
    mask[4:44, 4:60] = 0  # nearly the whole frame: no bucket fits
    cons = np.array([[20, 20, 24, 23], [40, 30, 44, 33]], np.int32)
    weights = TE.ArapWeights(w_fit=10.0, w_reg=0.5)
    cfg = TConfig(**SHORT)
    assert TB.make_task(0, 0, rgb, mask, cons, weights) is None
    pinned = add_border_pins(cons, Ws, Hs)
    out = TB.run_tasks([], [(0, 0, rgb, mask, pinned)], cfg, device="cpu",
                       weights=weights)[(0, 0)]
    ref = TA.ArapDeformer(cfg, weights, device="cpu").deform(rgb, mask, cons)
    np.testing.assert_allclose(out.flow, ref.flow, atol=1e-5)
    # the weights matter: the default weights give another flow
    ref_default = TA.ArapDeformer(cfg, device="cpu").deform(rgb, mask, cons)
    assert np.abs(ref.flow - ref_default.flow).max() > 0.05
    # and JAX's run_tasks on the same inputs
    jout = JB.run_tasks([], [(0, 0, rgb, mask, pinned)],
                        JConfig(**SHORT, backend="xla"),
                        weights=JE.ArapWeights(w_fit=10.0, w_reg=0.5))[(0, 0)]
    assert np.abs(out.flow - jout.flow).max() < FLOW_TOL


def _list_rows(tmp_path, frames, tag):
    return [r + [str(tmp_path / f"{tag}{i}.{e}") for e in ("flo", "w.png",
                                                             "m.png")]
            for i, r in enumerate(frames)]


def test_deform_host_raster_splats_every_frame(tmp_path, monkeypatch):
    """ARAP_RASTER=host on a list of two same-shape frames: each frame runs
    the per-frame deformer's exact host splat (two calls of the native
    rasterizer), with ArapDeformer(raster="host")'s products."""
    from arap_flow_tpu_torch.native import runtime as TR

    calls = []
    splat = TR.rasterize_warp

    def spy(*a, **k):
        calls.append(a[0].shape)
        return splat(*a, **k)

    monkeypatch.setattr(TR, "rasterize_warp", spy)
    rows = _list_rows(tmp_path, _write_tree(tmp_path, n=2), "h")
    fw = FrameworkConfig(solver=TConfig(**SHORT), raster="host")
    failed = TD.deform_frames([TD.FramePaths(*r) for r in rows], fw.solver,
                              device="cpu", fw=fw)
    assert failed == [] and len(calls) == 2
    calls.clear()
    deformer = TA.ArapDeformer(fw.solver, raster="host", device="cpu")
    for r in rows:
        ref = deformer.deform(load_rgb(r[0]), load_mask(r[1]),
                              TD.read_constraint_file(r[2]))
        u, v = TF.flow_read(r[3])
        np.testing.assert_array_equal(np.dstack([u, v]), ref.flow)
        np.testing.assert_array_equal(load_rgb(r[4]), ref.warped_rgb)
        np.testing.assert_array_equal(load_mask(r[5]), ref.warped_mask)
    assert len(calls) == 2


def test_deform_list_isolates_a_bad_frame(tmp_path, capsys, monkeypatch):
    """A chunk holding one frame whose constraint file is missing fails as a
    batch; it is retried frame by frame, the good frames are written (with
    the per-frame deformer's products) and the bad one is reported."""
    frames = _write_tree(tmp_path, n=3)
    frames[1][2] = str(tmp_path / "missing.txt")
    rows = _list_rows(tmp_path, frames, "b")
    cfg = TConfig(**SHORT)
    failed = TD.deform_frames([TD.FramePaths(*r) for r in rows], cfg,
                              device="cpu")
    assert [f.rgb for f in failed] == [rows[1][0]]
    out = capsys.readouterr().out
    assert "retrying frame by frame" in out and "frame failed" in out
    deformer = TA.ArapDeformer(cfg, device="cpu")
    for i in (0, 2):
        ref = deformer.deform(load_rgb(rows[i][0]), load_mask(rows[i][1]),
                              TD.read_constraint_file(rows[i][2]))
        u, v = TF.flow_read(rows[i][3])
        np.testing.assert_array_equal(np.dstack([u, v]), ref.flow)
    assert not (tmp_path / "b1.flo").exists()
    monkeypatch.setattr(TD, "make_config", lambda s: cfg)
    with pytest.raises(SystemExit, match="1 of 3 frames failed"):
        lst = tmp_path / "bad.txt"
        lst.write_text("\n".join(" ".join(r) for r in rows) + "\n")
        TD.main([str(lst), "--device", "cpu"])


def test_framework_config_crop_default_matches_jax():
    """tests/test_config_utils.py: crop is on by default."""
    assert FrameworkConfig().crop is True
    assert JFramework().crop is True
