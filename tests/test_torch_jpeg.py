"""The port's JPEG codec (native C++) and PIL-exact resizes (numpy) against
PIL, which the JAX package uses for both.

- Decode: bitwise equal to ``np.array(Image.open(p).convert("RGB"))`` for
  4:4:4, 4:2:2, 4:2:0 and grayscale files at qualities 50/90/98, at odd
  sizes (1×1, 17×23, 23×17, 2×40, 481×855) and with restart markers; what
  it does not decode (CMYK, 12-bit, other sampling factors, a truncated
  baseline or progressive file) raises ValueError. Progressive decodes
  are held to PIL in tests/test_torch_progressive.py.
- Encode: PIL's decode of a port-encoded file equals the port's decode;
  the quantization tables are libjpeg's at the same quality, and the mean
  error within 5% of libjpeg's own encode.
- Resize: ``resize_lanczos`` and ``resize_nearest`` bitwise equal to PIL's
  LANCZOS and NEAREST, down (the ``--size`` ratios) and up (the background
  fit's 1–2× ratios), for RGB and gray.
"""

import io

import numpy as np
import pytest
from PIL import Image

from arap_flow_tpu.io import image as JI
from arap_flow_tpu_torch.io import image as TI
from arap_flow_tpu_torch.io.resize import resize_lanczos, resize_nearest
from arap_flow_tpu_torch.native import runtime as TR

SIZES = ((1, 1), (17, 23), (23, 17), (2, 40), (481, 855))
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _natural(H, W, seed):
    """Blocks plus noise: every coefficient band busy, some IDCT clipping."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(0, 255, (H // 8 + 2, W // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:H, :W]
    return np.clip(base + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(np.uint8)


def _pil_jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.array(im.convert("RGB"))


@pytest.mark.parametrize("quality", [50, 90, 98])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_decode_bitwise_equal_to_pil(tmp_path, sampling, quality):
    for k, (H, W) in enumerate(SIZES):
        img = _natural(H, W, 100 * k + quality)
        arr = img[..., 1] if sampling == "gray" else img
        kw = {} if sampling == "gray" else {
            "subsampling": SUBSAMPLING[sampling]}
        for rst in (0, 2):
            data = _pil_jpeg(arr, quality=quality,
                             **kw, **({"restart_marker_blocks": rst}
                                      if rst else {}))
            assert (b"\xff\xdd" in data) == bool(rst)
            ref = _pil_rgb(data)
            got = TR.jpeg_decode(data)
            if sampling == "gray":
                assert got.shape == (H, W)
                got = np.repeat(got[..., None], 3, axis=2)
            np.testing.assert_array_equal(got, ref, err_msg=f"{H}x{W} {rst}")
        # and through io.image, against the JAX package's PIL path
        p = tmp_path / f"f{k}.jpg"
        p.write_bytes(data)
        np.testing.assert_array_equal(TI.load_rgb(p), JI.load_rgb(p))
        np.testing.assert_array_equal(TI.load_mask(p), JI.load_mask(p))
        assert TI.image_size(p) == (H, W)


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """`data` with the byte at `offset` past `marker` set to `value`."""
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def test_unsupported_files_raise_value_error(tmp_path):
    img = _natural(32, 48, 7)
    progressive = _pil_jpeg(img, progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, format="JPEG")
    base = _pil_jpeg(img, subsampling=0)
    twelve_bit = _patched(base, b"\xff\xc0", 4, 12)  # sample precision
    sampling_440 = _patched(base, b"\xff\xc0", 11, 0x12)  # Y h1v2
    truncated = base[: len(base) // 2]
    cases = {"truncated progressive": progressive[: len(progressive) // 2],
             "CMYK": cmyk.getvalue(),
             "12-bit": twelve_bit, "4:4:0": sampling_440,
             "truncated": truncated, "not a JPEG": b"\xff\xd8garbage"}
    for name, data in cases.items():
        with pytest.raises(ValueError):
            TR.jpeg_decode(data)
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            TI.load_rgb(p)
    assert TR.jpeg_info(progressive)[:2] == (32, 48)  # the header still reads
    (tmp_path / "empty.jpg").write_bytes(b"")
    with pytest.raises(ValueError):
        TI.load_rgb(tmp_path / "empty.jpg")


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 23, 3), (33, 50),
                                   (120, 210, 3)])
@pytest.mark.parametrize("quality", [75, 95])
def test_pil_decodes_encoder_files_as_the_port(tmp_path, shape, quality):
    arr = _natural(shape[0], shape[1], 3)
    arr = arr if len(shape) == 3 else arr[..., 0]
    p = tmp_path / "e.jpg"
    TI.save_image(p, arr, quality=quality)
    data = p.read_bytes()
    with Image.open(p) as im:
        assert im.format == "JPEG" and im.size == (shape[1], shape[0])
        pil = np.array(im)
        pil_q = im.quantization
    got = TR.jpeg_decode(data)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(TI.load_rgb(p), JI.load_rgb(p))
    pil_file = _pil_jpeg(arr, quality=quality)  # 4:2:0, as the port's
    with Image.open(io.BytesIO(pil_file)) as ref:
        assert pil_q == ref.quantization
        pil_err = np.abs(np.array(ref).astype(float) - arr).mean()
    # a faithful encode, not just a decodable one: within 5% of libjpeg's
    # own error at the same quality and sampling
    assert np.abs(got.astype(float) - arr).mean() <= 1.05 * pil_err + 0.05


DOWN = [((720, 1280), (871, 490)), ((480, 854), (864, 486)),
        ((1080, 1920), (864, 486)), ((61, 97), (40, 26))]
UP = [((40, 70), (123, 71)), ((300, 400), (456, 608)), ((5, 7), (9, 13)),
      ((17, 23), (17, 40))]


@pytest.mark.parametrize("shape,size", DOWN + UP)
def test_resizes_bitwise_equal_to_pil(shape, size):
    rng = np.random.default_rng(shape[0] * 7 + size[0])
    img = _natural(shape[0], shape[1], int(rng.integers(1000)))
    ref = np.array(Image.fromarray(img).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(img, size), ref)
    gray = img[..., 2]
    np.testing.assert_array_equal(
        resize_lanczos(gray, size),
        np.array(Image.fromarray(gray).resize(size, Image.LANCZOS)))
    mask = rng.integers(0, 5, shape).astype(np.uint8)
    np.testing.assert_array_equal(
        resize_nearest(mask, size),
        np.array(Image.fromarray(mask).resize(size, Image.NEAREST)))
    np.testing.assert_array_equal(resize_lanczos(img, shape[::-1]), img)
    with pytest.raises(ValueError):
        resize_lanczos(img, (0, 3))
