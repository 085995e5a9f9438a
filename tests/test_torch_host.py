"""The port's host helpers (numpy copies) equal their JAX-package originals,
and the port never imports jax or arap_flow_tpu."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from arap_flow_tpu.io import constraints as JC
from arap_flow_tpu.io import flo as JF
from arap_flow_tpu.io import image as JI
from arap_flow_tpu.models import arap as JA
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.pipeline import batch as JB
from arap_flow_tpu_torch.io import constraints as TC
from arap_flow_tpu_torch.io import flo as TF
from arap_flow_tpu_torch.io import image as TI
from arap_flow_tpu_torch.models import arap as TA
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.pipeline import batch as TB

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "arap_flow_tpu_torch"


@pytest.mark.parametrize("W,H", [(7, 5), (1, 4), (5, 1), (1, 1), (64, 48)])
def test_add_border_pins_equal(W, H):
    rng = np.random.default_rng(W * 100 + H)
    cons = rng.integers(0, 50, (6, 4)).astype(np.int32)
    np.testing.assert_array_equal(TC.add_border_pins(cons, W, H),
                                  JC.add_border_pins(cons, W, H))


def test_read_constraint_file_equal(tmp_path):
    cons = np.random.default_rng(0).integers(0, 99, (9, 4)).astype(np.int32)
    p = tmp_path / "c.txt"
    JC.write_constraint_file(p, cons)
    np.testing.assert_array_equal(TC.read_constraint_file(p),
                                  JC.read_constraint_file(p))
    (tmp_path / "e.txt").write_text("")
    assert TC.read_constraint_file(tmp_path / "e.txt").shape == (0, 4)
    (tmp_path / "bad.txt").write_text("3\n1 2 3 4\n")
    with pytest.raises(ValueError):
        TC.read_constraint_file(tmp_path / "bad.txt")


def test_flo_bytes_identical(tmp_path):
    """.flo files are byte-identical: encode, write, read back."""
    flow = np.random.default_rng(1).standard_normal((13, 17, 2)).astype(
        np.float32) * 20
    assert TF.flow_encode(flow) == JF.flow_encode(flow)
    assert TF.flow_encode(flow[..., 0], flow[..., 1]) == JF.flow_encode(flow)
    TF.flow_write(tmp_path / "t.flo", flow)
    JF.flow_write(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    u, v = TF.flow_read(tmp_path / "j.flo")
    np.testing.assert_array_equal(np.dstack([u, v]), flow)
    with pytest.raises(ValueError):
        TF.flow_decode(b"XXXX" + (tmp_path / "t.flo").read_bytes()[4:])


def test_image_io_equal(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 255, (9, 11, 3)).astype(np.uint8)
    mask = rng.integers(0, 3, (9, 11)).astype(np.uint8) * 100
    TI.save_image(tmp_path / "t.png", rgb)
    JI.save_image(tmp_path / "j.png", rgb)
    # the port writes PNGs with its own codec: other bytes, the same pixels
    np.testing.assert_array_equal(JI.load_rgb(tmp_path / "t.png"),
                                  JI.load_rgb(tmp_path / "j.png"))
    np.testing.assert_array_equal(TI.load_rgb(tmp_path / "j.png"), rgb)
    TI.save_image(tmp_path / "m.png", mask)
    np.testing.assert_array_equal(TI.load_rgb(tmp_path / "t.png"),
                                  JI.load_rgb(tmp_path / "t.png"))
    np.testing.assert_array_equal(TI.load_mask(tmp_path / "m.png"),
                                  JI.load_mask(tmp_path / "m.png"))
    np.testing.assert_array_equal(TI.load_mask(tmp_path / "t.png"),
                                  JI.load_mask(tmp_path / "t.png"))
    assert TI.image_size(tmp_path / "m.png") == (9, 11)


def _segment(H, W, center, size, disp, seed):
    """Elliptical object mask, rgb and a translated constraint grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ell = ((yy - center[0]) / (size[0] / 2)) ** 2 + (
        (xx - center[1]) / (size[1] / 2)) ** 2 < 1.0
    mask = np.where(ell, 0, 255).astype(np.uint8)
    ys, xs = np.mgrid[0:H:4, 0:W:4]
    sel = ell[::4, ::4]
    cons = np.stack([xs[sel], ys[sel], xs[sel] + disp[1], ys[sel] + disp[0]],
                    1).astype(np.int32)
    return rng.integers(0, 255, (H, W, 3)).astype(np.uint8), mask, cons


SEGMENTS = [
    ((120, 160), (60, 80), (30, 40), (3, -5)),
    ((120, 160), (40, 90), (20, 100), (-6, 4)),   # wide and flat
    ((120, 160), (70, 40), (50, 30), (0, 0)),     # tall and narrow
    ((120, 160), (60, 80), (200, 300), (2, 2)),   # larger than any bucket
]


@pytest.mark.parametrize("seg", range(len(SEGMENTS)))
def test_bucket_helpers_equal(seg):
    (H, W), center, size, disp = SEGMENTS[seg]
    _, mask, cons = _segment(H, W, center, size, disp, seg)
    assert TA.CROP_BUCKETS == JA.CROP_BUCKETS
    assert TA.directional_pads(cons) == JA.directional_pads(cons)
    assert TA.directional_pads(cons[:0]) == JA.directional_pads(cons[:0])
    for margin in (2, 8):
        assert (TA.pick_bucket(mask, cons, margin=margin)
                == JA.pick_bucket(mask, cons, margin=margin))
    assert TA.crop_box(mask, cons) == JA.crop_box(mask, cons)
    assert (TA.crop_box(mask, cons, margin=3, h_mult=16, w_mult=32, extra=5)
            == JA.crop_box(mask, cons, margin=3, h_mult=16, w_mult=32, extra=5))
    for lo, hi, size_, limit in ((3, 9, 10, 20), (15, 19, 8, 20), (0, 4, 4, 4)):
        assert TA.place_span(lo, hi, size_, limit) == JA.place_span(
            lo, hi, size_, limit)


# (128, 32) without (32, 128): a wide, flat object solves transposed
BUCKETS_SMALL = ((32, 64), (64, 32), (48, 64), (64, 64), (64, 96), (96, 96),
                 (96, 128), (128, 128), (128, 32))


@pytest.mark.parametrize("seg", range(len(SEGMENTS)))
@pytest.mark.parametrize("buckets", [JA.CROP_BUCKETS, BUCKETS_SMALL])
def test_make_task_boxes_equal(seg, buckets):
    (H, W), center, size, disp = SEGMENTS[seg]
    rgb, mask, cons = _segment(H, W, center, size, disp, seg)
    jt = JB.make_task(3, 1, rgb, mask, cons, JE.ArapWeights(), buckets=buckets)
    tt = TB.make_task(3, 1, rgb, mask, cons, TE.ArapWeights(), buckets=buckets)
    if jt is None:
        assert tt is None
        return
    for f in ("pair_idx", "seg_id", "frame_hw", "y0", "x0", "bucket", "cy0",
              "cx0", "canvas", "transposed"):
        assert getattr(tt, f) == getattr(jt, f), f
    np.testing.assert_array_equal(tt.rgb, jt.rgb)
    for f in ("mask_u8", "con_tgt_i16", "wf2", "wr2"):
        np.testing.assert_array_equal(getattr(tt.ops, f), getattr(jt.ops, f))


def test_make_task_transposes_wide_objects():
    """The wide-flat segment takes the tall bucket transposed in both."""
    (H, W), center, size, disp = SEGMENTS[1]
    rgb, mask, cons = _segment(H, W, center, size, disp, 1)
    tt = TB.make_task(0, 0, rgb, mask, cons, TE.ArapWeights(),
                      buckets=BUCKETS_SMALL)
    assert tt is not None and tt.transposed


def test_max_chunk_for_cap():
    assert TB.max_chunk_for((224, 384)) == TB.MAX_CHUNK == 24
    assert TB.max_chunk_for((512, 896)) >= 1
    assert TB.max_chunk_for((100000, 100000)) == 1
    # the budget is per device: a chunk split over n_data devices (--mode
    # sharded) is n_data times as large, as JAX's max_chunk_for(bucket, n)
    for bucket in ((224, 384), (512, 896), (100000, 100000)):
        assert TB.max_chunk_for(bucket, 4) == 4 * TB.max_chunk_for(bucket)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+arap_flow_tpu(\.|\s|$)"
    r"|from\s+arap_flow_tpu(\.|\s))", re.M)


def _port_sources():
    """The package's .py files, without build outputs under _build/."""
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.relative_to(PORT).parts)


def _card_sources():
    """The card check: the launcher, the card test files it runs and their
    helper, which must run where neither jax nor PIL is installed."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    files = chip_smoke.card_files()
    assert {f.name for f in files} >= {"test_torch_card_kernels.py",
                                       "test_torch_card_paths.py",
                                       "test_torch_card_pipelines.py"}
    return [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_card.py", *files]


def test_port_never_imports_jax_source():
    files = _port_sources() + _card_sources()
    assert len(files) > 15
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_port_never_imports_jax_at_runtime():
    """Importing every port module, the card launcher, its test files and
    their helper loads neither jax nor arap_flow_tpu, nor PIL: the port
    runs where none of them is installed."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in _port_sources() if p.name != "__init__.py"
    ) + ["arap_flow_tpu_torch.compat"]
    assert {"arap_flow_tpu_torch.compat.opt_api", "arap_flow_tpu_torch.ops.lm",
            "arap_flow_tpu_torch.ops.generic",
            "arap_flow_tpu_torch.ops.graph"} <= set(mods)
    mods += [f.stem for f in _card_sources()]
    code = (
        "import sys, importlib\n"
        "sys.path.insert(0, 'tests')\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'arap_flow_tpu', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
