"""The port's progressive JPEG decode (native C++) against PIL, which the JAX
package reads frames and backgrounds with.

- Decode: PIL-encoded ``progressive=True`` files (libjpeg's simple
  progression: DC first and refinement scans, AC spectral selection with
  EOB runs, AC successive approximation) at 4:2:0, 4:2:2, 4:4:4 and
  grayscale, at sizes that are not multiples of 8 or 16, with
  ``optimize=True`` (per-scan Huffman tables) and with restart intervals,
  decode bitwise equal to ``Image.open(...).convert("RGB")``.
- Refused with ValueError: a truncated progressive file, and one whose scan
  script stops before the last refinement scans (libjpeg smooths such
  blocks, which the port does not reproduce: the decoder raises its
  ``JpegUnsupported`` kind, and ``io.image`` hands the file to PIL, held
  in tests/test_torch_jpeg.py).
- ``para_gen`` of both packages with a progressive ``--bg_dir``: the
  composited inputs are pixel-identical, and the flows, list and masks hold
  the dryrun parity's tolerances (tests/test_torch_dryrun.py).
"""

import io
import os
import os.path as osp

import numpy as np
import pytest
from PIL import Image

from arap_flow_tpu.io import flo as JF
from arap_flow_tpu.io import image as JI
from arap_flow_tpu.ops.solver import SolverConfig as JConfig
from arap_flow_tpu.pipeline import para_gen as JP
from arap_flow_tpu_torch.io import image as TI
from arap_flow_tpu_torch.native import runtime as TR
from arap_flow_tpu_torch.ops.solver import SolverConfig as TConfig
from arap_flow_tpu_torch.pipeline import para_gen as TP
from test_torch_dryrun import DRYRUN, _make_mini_dataset

SIZES = ((1, 1), (17, 23), (23, 17), (2, 40), (33, 50), (121, 203))
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _natural(H, W, seed):
    """Blocks plus noise: every coefficient band busy, some IDCT clipping."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(0, 255, (H // 8 + 2, W // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:H, :W]
    return np.clip(base + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(np.uint8)


def _progressive(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", progressive=True, **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.array(im.convert("RGB"))


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_progressive_decode_bitwise_equal_to_pil(tmp_path, sampling, quality):
    for k, (H, W) in enumerate(SIZES):
        img = _natural(H, W, 100 * k + quality)
        arr = img[..., 1] if sampling == "gray" else img
        kw = {} if sampling == "gray" else {
            "subsampling": SUBSAMPLING[sampling]}
        for extra in ({}, {"optimize": True}, {"restart_marker_rows": 1}):
            data = _progressive(arr, quality=quality, **kw, **extra)
            assert data[data.index(b"\xff\xc2"):][:2] == b"\xff\xc2"
            assert (b"\xff\xdd" in data) == ("restart_marker_rows" in extra)
            ref = _pil_rgb(data)
            got = TR.jpeg_decode(data)
            if sampling == "gray":
                assert got.shape == (H, W)
                got = np.repeat(got[..., None], 3, axis=2)
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"{H}x{W} {extra}")
        # and through io.image, against the JAX package's PIL path
        p = tmp_path / f"f{k}.jpg"
        p.write_bytes(data)
        np.testing.assert_array_equal(TI.load_rgb(p), JI.load_rgb(p))
        np.testing.assert_array_equal(TI.load_mask(p), JI.load_mask(p))
        assert TI.image_size(p) == (H, W)


def _scan_starts(data: bytes) -> list[int]:
    """Offsets of the SOS markers of a JPEG (entropy-coded data has every
    0xFF byte stuffed, so a marker search is exact)."""
    out, i = [], 2
    while True:
        i = data.find(b"\xff\xda", i)
        if i < 0:
            return out
        out.append(i)
        i += 2


def test_truncated_and_unrefined_progressive_raise(tmp_path):
    data = _progressive(_natural(40, 56, 3), quality=90)
    for cut in (len(data) // 2, len(data) - 2, _scan_starts(data)[-1]):
        with pytest.raises(ValueError):
            TR.jpeg_decode(data[:cut])
        p = tmp_path / f"cut{cut}.jpg"
        p.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            TI.load_rgb(p)
    # the scan script cut after its first AC scans, with an EOI: a valid
    # file that PIL decodes with block smoothing, which the port refuses
    starts = _scan_starts(data)
    assert len(starts) >= 6
    early = data[: starts[-4]] + b"\xff\xd9"
    assert _pil_rgb(early).shape == (40, 56, 3)
    with pytest.raises(ValueError, match="unrefined"):
        TR.jpeg_decode(early)


def test_para_gen_with_progressive_backgrounds_matches_jax(tmp_path):
    """Both packages' para_gen on the dryrun's mini dataset with two
    progressive backgrounds: the same draws composite pixel-identical
    inputs, and the products hold tests/test_torch_dryrun.py's gates."""
    inp = tmp_path / "data"
    _make_mini_dataset(str(inp), n_frames=2)
    os.makedirs(inp / "bg")
    for i in range(2):
        (inp / "bg" / f"b{i}.jpg").write_bytes(_progressive(
            _natural(60 + 7 * i, 100, 40 + i), quality=90,
            subsampling=2 - 2 * i))
    outs = {}
    for name, P, cfg in (("jax", JP, JConfig(**DRYRUN, backend="xla")),
                         ("torch", TP, TConfig(**DRYRUN))):
        out = str(tmp_path / name)
        kw = {"device": "cpu"} if name == "torch" else {}
        lines = P.main_pipeline(
            P.PipelineFlags(input=str(inp), output=out, seed=0,
                            mode="batched", bg_dir=str(inp / "bg"),
                            match_downscale=4, **kw),
            solver_cfg=cfg)
        outs[name] = (out, lines)
    (jo, jl), (to, tl) = outs["jax"], outs["torch"]
    assert [osp.relpath(p, to) for ln in tl for p in ln.split(" ")] == [
        osp.relpath(p, jo) for ln in jl for p in ln.split(" ")]
    assert len(tl) == 1
    name = "00000"
    rgb = [np.array(Image.open(osp.join(o, "inpRGB", "seq0", name + ".png")))
           for o in (to, jo)]
    np.testing.assert_array_equal(rgb[0], rgb[1])
    mask = np.array(Image.open(osp.join(to, "inpMasks", "seq0",
                                        name + ".png")))
    assert (rgb[0][mask == 0] > 0).any()  # a background was composited
    tu, tv = JF.flow_read(osp.join(to, "Flow", "seq0", name + ".flo"))
    ju, jv = JF.flow_read(osp.join(jo, "Flow", "seq0", name + ".flo"))
    obj = mask != 0
    assert np.abs(tu - ju)[obj].max() < 0.05
    assert np.abs(tv - jv)[obj].max() < 0.05
    wm = [np.array(Image.open(osp.join(o, "wMasks", "seq0", name + ".png")))
          for o in (to, jo)]
    assert (wm[0] != wm[1]).mean() < 1e-3
