"""The ``davis1080.seq24-bg`` cell at a cut the CPU runs in seconds, with
a cut of its own: small source frames resized by ``--size`` to a small
target, two backgrounds of another size than the frames, a 2 x 2 x 30
schedule. A sound run is correct; a background crop shifted by 1 px,
frames resized with NEAREST in place of LANCZOS, and a warped frame
composited over a stale background are not; the control, the
reference computed in bfloat16, fails a limit where the program meets them
all. The control at the cell's own size needs an NVIDIA GPU (the `cuda`
marker):

    python3 -m pytest benchmark/tests/test_bench_fullres.py -m cuda
"""

import dataclasses
import time

import numpy as np
import pytest

from benchmark import harness, probe

CELL = "davis1080.seq24-bg"
SOURCE_HW = (324, 432)  # 2.25 x the target's height
# davis480's CPU cut (benchmark/tests/cut.py) with its geometry scaled by
# 2.25, written at SOURCE_HW and resized to 192 x 144
WORKLOAD = {
    "height": 144, "width": 192, "source_height": SOURCE_HW[0],
    "source_width": SOURCE_HW[1], "sequences": [3, 2], "sample_pairs": 3,
    "backgrounds": {"count": 2, "height": 336, "width": 448,
                    "jpeg_quality": 95},
    "objects": [
        {"id": 1, "start": 0.0, "scale": 2.25, "nonrigid": 0,
         "sizes": [[20, 30], [24, 36], [28, 40]],
         "centre_y": [4.5, 90, 135, 0], "centre_x": [6.75, 112.5, 157.5, 0]},
        {"id": 2, "start": 1.0, "scale": 2.25, "nonrigid": 6.75,
         "sizes": [[36, 40], [38, 44]],
         "centre_y": [4.5, 213.75, 236.25, 1],
         "centre_x": [4.5, 292.5, 315, 2]}]}
CONFIG = {"schedule": [2, 2, 30],
          "flags": ["--mode", "batched", "--multseg", "--fd", "1",
                    "--schedule", "parity", "--narap", "2",
                    "--size", "192", "144"],
          "limits": {"flow_epe_px": 0.1, "wmask_mismatch": 0.01,
                     "wrgb_mean_abs": 1.0, "inp_max_abs": 0.0,
                     "sample_missing": 0.0, "wrgb_bg_max_abs": 0.0}}
SEED = 123456789012


def run():
    return harness.run_cell(CELL, SEED, 0.1, False, time.time(),
                            device="cpu", require_chip=False,
                            cfg_override=CONFIG, wl_override=WORKLOAD)


def test_a_run_at_the_cut_is_correct():
    code, res = run()
    assert code == 0 and res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 3
    assert res["compared"]["wrgb_bg_max_abs"]["value"] == 0
    manifest = harness.load_cell(CELL)[0]
    assert set(res["metrics"]) == {m["name"] for m in harness.cell_metrics(
        manifest, CELL, "end_to_end")}


def _background_shifted(monkeypatch):
    from arap_flow_tpu_torch.pipeline import para_gen

    fit = para_gen.BackgroundPool.fit
    monkeypatch.setattr(para_gen.BackgroundPool, "fit",
                        lambda self, bg, shape: fit(self, np.roll(bg, 1, 1),
                                                    shape))


def _frames_nearest(monkeypatch):
    from arap_flow_tpu_torch.pipeline import para_gen

    lanczos = para_gen.resize_lanczos

    def resize(img, size):  # the frames only: the backgrounds are larger
        if img.shape[:2] == SOURCE_HW:
            return para_gen.resize_nearest(img, size)
        return lanczos(img, size)

    monkeypatch.setattr(para_gen, "resize_lanczos", resize)


def _composite_stale(monkeypatch):
    """The warped frame's composite alone at fault: each pair's over the
    background of the pair finished before it, the first's over none; the
    input frame keeps its own."""
    from arap_flow_tpu_torch.pipeline import para_gen

    finish, seen = para_gen.finish_pair, [None]

    def stale(work, seg_results, writer=None):
        seen.append(work.bgim)
        return finish(dataclasses.replace(work, bgim=seen[-2]), seg_results,
                      writer)

    monkeypatch.setattr(para_gen, "finish_pair", stale)


FAULTS = {"background_shifted": _background_shifted,
          "frames_nearest": _frames_nearest,
          "composite_stale": _composite_stale}
# the number each fault moves: the input frame, or the composite alone
MOVES = {"background_shifted": "inp_max_abs", "frames_nearest": "inp_max_abs",
         "composite_stale": "wrgb_bg_max_abs"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    code, res = run()
    assert code == 0
    assert res["correct"] is False, res["compared"]
    assert res["compared"][MOVES[fault]]["value"] > 0
    if fault == "composite_stale":
        assert res["compared"]["inp_max_abs"]["value"] == 0


def test_control_fails_where_the_program_passes_at_the_cut():
    (r,) = probe.readings(CELL, [SEED], control=True, device="cpu",
                          cfg_override=CONFIG, wl_override=WORKLOAD)
    limits = CONFIG["limits"]
    assert r["written"] == r["attempted"] == 3
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r


@pytest.mark.cuda
def test_control_fails_where_the_program_passes():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.cache_env()
    limits = harness.load_cell(CELL)[2]["limits"]
    (r,) = probe.readings(CELL, [20261018], control=True)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
