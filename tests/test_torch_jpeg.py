"""The port's JPEG codec (native C++) and PIL-exact resizes (numpy) against
PIL, which the JAX package uses for both.

- Decode: bitwise equal to ``np.array(Image.open(p).convert("RGB"))`` for
  4:4:4, 4:2:2, 4:2:0 and grayscale files at qualities 50/90/98, at odd
  sizes (1×1, 17×23, 23×17, 2×40, 481×855) and with restart markers.
  Progressive decodes are held to PIL in tests/test_torch_progressive.py.
- The other variants, bitwise equal to ``np.array(Image.open(p))`` and
  through ``load_rgb``/``load_mask`` to the JAX package's: PIL-written
  CMYK files, and files PIL cannot write, made here by a small numpy
  baseline encoder with the Annex K tables (4:4:0, 4:1:1, h4v2, mixed
  chroma factors, chroma sampled above luma, YCCK, CMYK without an Adobe
  marker).
- Refusals: a broken file (truncated, bad tables, sampling factors libjpeg
  refuses too) raises ValueError, as PIL raises; a file of a variant the
  native decoder does not implement (arithmetic coding, 12-bit, lossless,
  hierarchical, a DNL height, an unrefined progressive file) goes to PIL
  and gives the JAX package's result, and where importing PIL fails it
  raises an ImportError that names PIL and the variant.
- Encode: PIL's decode of a port-encoded file equals the port's decode;
  the quantization tables are libjpeg's at the same quality, and the mean
  error within 5% of libjpeg's own encode.
- Resize: ``resize_lanczos`` and ``resize_nearest`` bitwise equal to PIL's
  LANCZOS and NEAREST, down (the ``--size`` ratios) and up (the background
  fit's 1–2× ratios), for RGB and gray.
"""

import io
import os
import struct
import subprocess
import sys
import textwrap

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# the orthonormal 8-point DCT-II matrix
DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                 * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                for u in range(8)])


def _segments(data: bytes):
    """(marker, body) of each marker segment before the first scan."""
    pos = 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2 : pos + 4])[0]
        yield data[pos + 1], data[pos + 4 : pos + 2 + n]
        pos += 2 + n


def _annex_k(quality: int):
    """The quantization tables (zigzag order) and Huffman tables that
    libjpeg writes at `quality` unless asked to optimize: Annex K's tables
    (K.1 scaled, K.3). Returns ({id: table}, {class/id: (DHT body,
    {symbol: (code, length)})})."""
    qt, huff = {}, {}
    for m, body in _segments(_pil_jpeg(np.zeros((8, 8, 3), np.uint8),
                                       quality=quality)):
        while m == 0xDB and body:
            qt[body[0] & 15] = np.frombuffer(body[1:65], np.uint8)
            body = body[65:]
        while m == 0xC4 and body:
            bits = list(body[1:17])
            n = sum(bits)
            vals, codes, code, k = body[17 : 17 + n], {}, 0, 0
            for length in range(1, 17):
                for _ in range(bits[length - 1]):
                    codes[vals[k]] = (code, length)
                    k, code = k + 1, code + 1
                code <<= 1
            huff[body[0]] = (body[: 17 + n], codes)
            body = body[17 + n:]
    return qt, huff


def _encode(planes, sampling, *, sof=0xC0, adobe=None, quality=90) -> bytes:
    """A one-scan Huffman JPEG of full-resolution component planes (each
    (H, W) uint8): component i is box-downsampled to sampling[i] = (h, v),
    edge-padded to whole MCUs, transformed with a float DCT and coded with
    the Annex K tables (luma ones for component 0). Three components get a
    JFIF marker; `adobe` adds an Adobe APP14 marker with that transform.
    `sof` is the frame marker written (the data stays baseline)."""
    H, W = planes[0].shape
    nc = len(planes)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qt, huff = _annex_k(quality)
    blocks = []  # per component: (rows, cols, 64) quantized, zigzag order
    for i, (plane, (h, v)) in enumerate(zip(planes, sampling)):
        he, ve = hmax // h, vmax // v
        dh, dw = -(-H * v // vmax), -(-W * h // hmax)
        p = np.pad(plane.astype(np.float64),
                   ((0, dh * ve - H), (0, dw * he - W)), mode="edge")
        p = p.reshape(dh, ve, dw, he).mean(axis=(1, 3))
        p = np.pad(p, ((0, mcuy * v * 8 - dh), (0, mcux * h * 8 - dw)),
                   mode="edge")
        tiles = p.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", DCT, tiles - 128.0, DCT)
        q = np.empty(64)
        q[ZIGZAG] = qt[min(i, 1)]
        coef = np.round(coef / q.reshape(8, 8)).astype(np.int64)
        blocks.append(coef.reshape(mcuy * v, mcux * h, 64)[:, :, ZIGZAG])
    out, acc, nbits = bytearray(), 0, 0

    def put(code: int, length: int) -> None:
        nonlocal acc, nbits
        acc, nbits = (acc << length) | code, nbits + length
        while nbits >= 8:
            nbits -= 8
            out.extend(b"\xff\x00" if (acc >> nbits) & 255 == 255
                       else bytes([(acc >> nbits) & 255]))
        acc &= (1 << nbits) - 1

    def put_coded(table: dict, run: int, value: int) -> None:
        size = abs(value).bit_length()
        put(*table[(run << 4) | size])
        if size:
            put(value if value >= 0 else value + (1 << size) - 1, size)

    pred = [0] * nc
    for my in range(mcuy):
        for mx in range(mcux):
            for i, (h, v) in enumerate(sampling):
                dc, ac = huff[min(i, 1)][1], huff[0x10 + min(i, 1)][1]
                for by in range(v):
                    for bx in range(h):
                        z = blocks[i][my * v + by, mx * h + bx]
                        put_coded(dc, 0, int(z[0]) - pred[i])
                        pred[i], run = int(z[0]), 0
                        for k in range(1, 64):
                            if z[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            put_coded(ac, run, int(z[k]))
                            run = 0
                        if run:
                            put(*ac[0x00])
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)  # pad with 1 bits

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    f = b"\xff\xd8"
    if nc == 3:
        f += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        f += seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    for t in (0, 1):
        f += seg(0xDB, bytes([t]) + qt[t].tobytes())
    f += seg(sof, struct.pack(">BHHB", 8, H, W, nc) + b"".join(
        bytes([i + 1, (h << 4) | v, min(i, 1)])
        for i, (h, v) in enumerate(sampling)))
    for t in (0x00, 0x10, 0x01, 0x11):
        f += seg(0xC4, huff[t][0])
    f += seg(0xDA, bytes([nc]) + b"".join(
        bytes([i + 1, 0x11 * min(i, 1)]) for i in range(nc)) + b"\x00\x3f\x00")
    return f + bytes(out) + b"\xff\xd9"


def _planes(n: int, H: int, W: int, seed: int) -> list:
    """n component planes of blocks plus noise."""
    img = _natural(H, W, seed)
    extra = _natural(H, W, seed + 1)
    return [np.ascontiguousarray(a) for a in
            [img[..., 0], img[..., 1], img[..., 2], extra[..., 0]][:n]]


def _assert_as_pil(tmp_path, data: bytes, name: str) -> None:
    """The decode equals np.array(Image.open(f)); load_rgb, load_mask and
    image_size equal the JAX package's."""
    with Image.open(io.BytesIO(data)) as im:
        ref = np.array(im)
    got = TR.jpeg_decode(data)
    np.testing.assert_array_equal(got, ref, err_msg=name)
    p = tmp_path / f"{name}.jpg"
    p.write_bytes(data)
    np.testing.assert_array_equal(TI.load_rgb(p), JI.load_rgb(p),
                                  err_msg=name)
    np.testing.assert_array_equal(TI.load_mask(p), JI.load_mask(p),
                                  err_msg=name)
    assert TI.image_size(p) == ref.shape[:2]


VARIANT_SIZES = ((1, 1), (17, 23), (23, 17), (2, 40), (61, 97))


@pytest.mark.parametrize("quality", [50, 95])
def test_pil_cmyk_files_bitwise(tmp_path, quality):
    """PIL writes CMYK with an Adobe marker (transform 0), inverted."""
    for k, (H, W) in enumerate(VARIANT_SIZES):
        buf = io.BytesIO()
        Image.fromarray(_natural(H, W, 30 * k + quality)).convert(
            "CMYK").save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        assert b"Adobe" in data
        assert TR.jpeg_decode(data).shape == (H, W, 4)
        _assert_as_pil(tmp_path, data, f"cmyk{k}")


# (sampling factors per component, Adobe transform)
VARIANTS = {
    "4:4:0": ([(1, 2), (1, 1), (1, 1)], None),
    "4:1:1": ([(4, 1), (1, 1), (1, 1)], None),
    "h4v2": ([(4, 2), (1, 1), (1, 1)], None),
    "h2v2 luma, h1v2 and h2v1 chroma": ([(2, 2), (1, 2), (2, 1)], None),
    "chroma above luma": ([(1, 1), (2, 2), (2, 2)], None),
    "YCCK 4:2:0": ([(2, 2), (1, 1), (1, 1), (2, 2)], 2),
    "YCCK, Adobe transform 1": ([(1, 1)] * 4, 1),
    "CMYK without an Adobe marker": ([(1, 1)] * 4, None),
    "CMYK 4:4:0": ([(1, 2), (1, 1), (1, 1), (1, 2)], 0),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_bitwise_equal_to_pil(tmp_path, variant):
    sampling, adobe = VARIANTS[variant]
    for k, (H, W) in enumerate(VARIANT_SIZES):
        data = _encode(_planes(len(sampling), H, W, k), sampling,
                       adobe=adobe)
        _assert_as_pil(tmp_path, data, f"{k}")


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """`data` with the byte at `offset` past `marker` set to `value`."""
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def test_corrupt_files_raise_value_error(tmp_path):
    img = _natural(32, 48, 7)
    progressive = _pil_jpeg(img, progressive=True)
    base = _pil_jpeg(img, subsampling=0)
    cases = {
        "truncated progressive": progressive[: len(progressive) // 2],
        "truncated": base[: len(base) // 2],
        # Y h3, Cb h2: not integral ratios (jdsample.c refuses them)
        "fractional sampling": _patched(_patched(base, b"\xff\xc0", 11, 0x31),
                                        b"\xff\xc0", 14, 0x21),
        # Y 4x4 and two chroma blocks: 18 blocks in an MCU (at most 10)
        "MCU too large": _patched(base, b"\xff\xc0", 11, 0x44),
        # 255 codes of length 1
        "bad Huffman table": _patched(base, b"\xff\xc4", 5, 0xFF),
        "not a JPEG": b"\xff\xd8garbage",
        "empty": b"",
    }
    for name, data in cases.items():
        with pytest.raises(ValueError) as err:
            TR.jpeg_decode(data)
        assert not isinstance(err.value, TR.JpegUnsupported), name
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            TI.load_rgb(p)
        with pytest.raises(ValueError):
            TI.load_mask(p)
        with pytest.raises(OSError):  # and PIL refuses it too
            JI.load_rgb(p)
    assert TR.jpeg_info(progressive)[:2] == (32, 48)  # the header still reads


def _unsupported_files() -> dict:
    """Files of variants the native decoder hands to PIL."""
    planes = _planes(3, 20, 30, 5)
    base = _encode(planes, [(1, 1)] * 3)
    progressive = _pil_jpeg(_natural(40, 56, 3), progressive=True,
                            quality=90)
    sos = [i for i in range(len(progressive) - 1)
           if progressive[i : i + 2] == b"\xff\xda"]
    return {
        "arithmetic": _encode(planes, [(1, 1)] * 3, sof=0xC9),
        "12-bit": _patched(base, b"\xff\xc0", 4, 12),
        "lossless": _encode(planes, [(1, 1)] * 3, sof=0xC3),
        "hierarchical": _encode(planes, [(1, 1)] * 3, sof=0xC5),
        "DNL": _patched(_patched(base, b"\xff\xc0", 5, 0), b"\xff\xc0", 6, 0),
        # the scan script cut after its first AC scans, with an EOI: libjpeg
        # block-smooths the unrefined coefficients
        "unrefined": progressive[: sos[-4]] + b"\xff\xd9",
    }


def _load_or_error(fn, p):
    try:
        return fn(p)
    except Exception as e:  # PIL's own refusal, compared by type
        return type(e)


def test_unsupported_files_go_to_pil(tmp_path):
    for name, data in _unsupported_files().items():
        with pytest.raises(TR.JpegUnsupported):
            TR.jpeg_decode(data)
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        for tf, jf in ((TI.load_rgb, JI.load_rgb),
                       (TI.load_mask, JI.load_mask)):
            want, got = _load_or_error(jf, p), _load_or_error(tf, p)
            if isinstance(want, type):
                assert got is want, (name, got, want)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    # PIL reads these two: the port's result is PIL's image
    for name in ("arithmetic", "unrefined"):
        assert TI.load_rgb(tmp_path / f"{name}.jpg").ndim == 3


def test_unsupported_files_without_pil_raise_import_error(tmp_path):
    files = _unsupported_files()
    # file names that do not name the variant: the message has to
    names = {"f0": files["arithmetic"], "f1": files["unrefined"],
             "f2": files["arithmetic"][:40]}  # truncated: corrupt
    for name, data in names.items():
        (tmp_path / f"{name}.jpg").write_bytes(data)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None  # any import of PIL raises
        from arap_flow_tpu_torch.io.image import load_mask, load_rgb
        for name in ("f0", "f1", "f2"):
            for fn in (load_rgb, load_mask):
                try:
                    fn({str(tmp_path)!r} + "/" + name + ".jpg")
                except Exception as e:
                    print(type(e).__name__, e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 6, proc.stdout
    for line, word in zip(lines, ("arithmetic", "arithmetic", "unrefined",
                                  "unrefined")):
        assert line.startswith("ImportError ") and "PIL" in line, line
        assert word in line, line
    assert all(line.startswith("ValueError ") for line in lines[4:]), lines


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
