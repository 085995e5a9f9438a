"""The port's PNG codec (numpy + zlib) against PIL, and its image helpers
against the JAX package's io/image.py.

The codec must read what PIL writes bit for bit (gray, gray+alpha, RGB,
RGBA and palette images of 1-8 bits, at zlib levels that make PIL pick
every row filter), and PIL must read the codec's files back bit for bit.
JPEG files go through the native codec (tests/test_torch_jpeg.py holds it
to PIL). What neither codec reads (16-bit PNGs, other formats) goes through
PIL, and where PIL is missing that raises an ImportError that names it.
"""

import builtins
import zlib

import numpy as np
import pytest
from PIL import Image

from arap_flow_tpu.io import image as JI
from arap_flow_tpu_torch.io import image as TI


def _natural(H, W, seed, C=3):
    """Smooth blocks plus noise: rows where PIL's adaptive filtering picks
    sub, up, average and paeth."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(0, 255, (H // 8 + 2, W // 8 + 2, C)),
                   np.ones((8, 8, 1)))[:H, :W]
    return np.clip(base + rng.normal(0, 9, (H, W, C)), 0, 255).astype(np.uint8)


def _pil_reference(path):
    with Image.open(path) as im:
        rgb = np.array(im.convert("RGB"))
    with Image.open(path) as im:
        arr = np.array(im)
    return rgb, (arr[:, :, 0] if arr.ndim == 3 else arr)


def _pil_images():
    rgb = _natural(37, 53, 0)
    yield "RGB", Image.fromarray(rgb)
    yield "L", Image.fromarray(rgb[..., 1])
    yield "RGBA", Image.fromarray(np.dstack([rgb, rgb[..., 2]]))
    yield "LA", Image.fromarray(rgb).convert("LA")


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_reads_pil_written_bit_equal(tmp_path, level):
    for mode, im in _pil_images():
        p = tmp_path / f"{mode}.png"
        im.save(p, compress_level=level)
        rgb, mask = _pil_reference(p)
        np.testing.assert_array_equal(TI.load_rgb(p), rgb, err_msg=mode)
        np.testing.assert_array_equal(TI.load_mask(p), mask, err_msg=mode)
        assert TI.image_size(p) == mask.shape


@pytest.mark.parametrize("colors", [2, 3, 7, 16, 17, 256])
def test_reads_palette_bit_equal(tmp_path, colors):
    """PIL writes a palette of n colours at 1, 2, 4 or 8 bits a pixel."""
    rng = np.random.default_rng(colors)
    idx = rng.integers(0, colors, (29, 43)).astype(np.uint8)
    im = Image.frombytes("P", (43, 29), idx.tobytes())
    im.putpalette(rng.integers(0, 256, 3 * colors).astype(np.uint8).tolist())
    for optimize in (False, True):
        p = tmp_path / f"p{optimize}.png"
        im.save(p, optimize=optimize)
        rgb, mask = _pil_reference(p)
        np.testing.assert_array_equal(TI.load_mask(p), mask)
        np.testing.assert_array_equal(TI.load_mask(p), idx)
        np.testing.assert_array_equal(TI.load_rgb(p), rgb)


@pytest.mark.parametrize("shape", [(31, 45), (31, 45, 3), (1, 1), (2, 300, 3)])
def test_pil_reads_codec_files_bit_equal(tmp_path, shape):
    arr = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(
        np.uint8)
    p = tmp_path / "t.png"
    TI.save_image(p, arr)
    with Image.open(p) as im:
        assert im.mode == ("L" if len(shape) == 2 else "RGB")
        np.testing.assert_array_equal(np.array(im), arr)
    got = TI.load_rgb(p) if len(shape) == 3 else TI.load_mask(p)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(JI.load_rgb(p), TI.load_rgb(p))
    assert TI.image_size(p) == shape[:2]


def test_codec_writes_level_1(tmp_path):
    """The IDAT is the filtered rows deflated at zlib level 1."""
    arr = _natural(20, 24, 3)
    data = TI.png_encode(arr)
    rows = arr.reshape(20, -1)
    filt = np.empty((20, 1 + rows.shape[1]), np.uint8)
    filt[:, 0] = 2
    filt[0, 1:] = rows[0]
    filt[1:, 1:] = rows[1:] - rows[:-1]
    assert zlib.compress(filt.tobytes(), 1) in data


def test_corrupt_png_raises(tmp_path):
    p = tmp_path / "bad.png"
    data = bytearray(TI.png_encode(_natural(8, 8, 4)))
    data[45] ^= 0xFF  # inside the IDAT: its CRC no longer matches
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        TI.load_rgb(p)
    p.write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        TI.load_mask(p)


def test_jpeg_goes_through_pil(tmp_path):
    """A JPEG that PIL wrote loads as PIL (and the JAX package) load it."""
    p = tmp_path / "f.jpg"
    Image.fromarray(_natural(16, 24, 5)).save(p, quality=95)
    rgb, _ = _pil_reference(p)
    np.testing.assert_array_equal(TI.load_rgb(p), rgb)
    np.testing.assert_array_equal(TI.load_rgb(p), JI.load_rgb(p))
    assert TI.image_size(p) == (16, 24)


def test_16_bit_png_goes_through_pil(tmp_path):
    p = tmp_path / "g16.png"
    arr = np.random.default_rng(6).integers(0, 65535, (9, 7)).astype(np.uint16)
    Image.fromarray(arr).save(p)
    np.testing.assert_array_equal(TI.load_mask(p), JI.load_mask(p))


def test_missing_pil_raises_naming_it(tmp_path, monkeypatch):
    png = tmp_path / "f.png"
    TI.save_image(png, _natural(8, 8, 7))
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    g16 = tmp_path / "g16.png"
    Image.fromarray(np.zeros((5, 6), np.uint16)).save(g16)
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(tmp_path / "f.bmp")
    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert TI.load_rgb(png).shape == (8, 8, 3)  # PNGs need no PIL
    TI.save_image(tmp_path / "g.png", np.zeros((4, 4), np.uint8))
    # nor do baseline JPEGs
    TI.save_image(tmp_path / "f.jpg", _natural(8, 8, 7))
    assert TI.load_rgb(tmp_path / "f.jpg").shape == (8, 8, 3)
    assert TI.image_size(tmp_path / "f.jpg") == (8, 8)
    for call in (lambda: TI.load_mask(g16),
                 lambda: TI.save_image(tmp_path / "g.bmp", np.zeros((4, 4))),
                 lambda: TI.image_size(tmp_path / "f.bmp")):
        with pytest.raises(ImportError, match="PIL"):
            call()


def test_mask_conversions_equal():
    mask = np.random.default_rng(8).integers(0, 4, (13, 17)).astype(np.uint8)
    assert TI.ARAP_BG == JI.ARAP_BG
    np.testing.assert_array_equal(TI.mask_to_arap(mask), JI.mask_to_arap(mask))
    for s in range(4):
        np.testing.assert_array_equal(TI.segment_mask_to_arap(mask, s),
                                      JI.segment_mask_to_arap(mask, s))
