"""Image IO and mask conventions (io/image.py of the JAX package).

PNG files go through a codec of numpy and the standard library's ``zlib``,
and JPEG files through the native host library's C++ codec
(``native/runtime.py``), so frames, masks and backgrounds load and save
where PIL is not installed:

- PNG read: non-interlaced 8-bit gray, gray+alpha, RGB and RGBA, and
  palette images of 1, 2, 4 or 8 bits, with all five row filters; alpha is
  dropped. PNG write: 8-bit gray and RGB, filter "up" on every row, zlib
  level 1.
- JPEG read: baseline and progressive Huffman-coded files of 8-bit
  samples with 1, 3 or 4 components and any sampling factors libjpeg
  takes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, h4v2, ...), decoded bitwise
  equal to PIL (libjpeg-turbo's defaults). Four-component files (CMYK,
  YCCK) decode to what ``np.array(Image.open(f))`` gives, PIL's inverted
  CMYK; ``load_rgb`` converts them as PIL's ``convert("RGB")`` does and
  ``load_mask`` keeps channel 0. JPEG write: baseline JFIF, 4:2:0, at
  ``quality`` (PIL's default 75).

The format is read from the file's first bytes; a file named .png or .jpg
that is neither raises ValueError, and so does a broken PNG or JPEG
(truncated data, bad tables). Any other file goes through PIL, imported
where it is needed: 16-bit or interlaced PNGs, JPEGs of a variant the
native decoder does not implement (arithmetic coding, 12-bit samples,
lossless, a DNL-defined height, a progressive file whose scans leave
low-frequency coefficients unrefined, which libjpeg smooths), other
formats. Where PIL is missing that raises an ImportError that names PIL
and the variant.

Mask conventions: annotation masks use 0 = background, nonzero = segment
id; ARAP solver masks use 0 = solve region, ARAP_BG = 255 = excluded.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..native import runtime as native

ARAP_BG = 255

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def pil_image(reason: str = "this image operation"):
    """PIL's Image module, or an ImportError that says what needs it
    (`reason`: the file or variant that PIL has to read)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{reason} needs PIL (Pillow), which is not installed: without "
            "it only PNG files (8-bit gray, RGB, RGBA and palette) and "
            "Huffman-coded 8-bit JPEG files (baseline and progressive, 1, 3 "
            "or 4 components) are read, and PNG and baseline JPEG files "
            "written") from e
    return Image


class _Unsupported(Exception):
    """A PNG this codec does not decode (handed to PIL)."""


_JPEG_SOI = b"\xff\xd8"


def _is_png(path) -> bool:
    return str(path).lower().endswith(".png")


def _is_jpeg(path) -> bool:
    return str(path).lower().endswith((".jpg", ".jpeg"))


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0]
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before IEND")


def _header(body: bytes):
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    return W, H, depth, ctype, comp, filt, interlace


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters; raw is (H, 1 + stride) uint8."""
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            row = line
        elif ftype == 1:  # sub: a running sum per byte lane, mod 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).ravel()
        elif ftype == 2:  # up
            row = line + prior
        elif ftype in (3, 4):
            row = np.frombuffer(_unfilter_seq(ftype, line, prior, bpp),
                                np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} unknown")
        out[y] = row
        prior = out[y]
    return out


def _unfilter_seq(ftype: int, line, prior, bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on the one decoded to
    its left, so the row is decoded byte by byte."""
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 255
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return cur


def png_decode(data: bytes):
    """Decode a PNG into (pixels, colour type, palette): pixels (H, W) for
    gray and palette indices, (H, W, C) otherwise; palette (N, 3) or None.
    Raises _Unsupported for what the codec does not read."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f"PNG header not valid: {header}")
    if interlace != 0 or not (depth == 8 or (ctype == 3 and depth in (1, 2, 4))):
        raise _Unsupported(f"depth {depth}, colour type {ctype}, "
                           f"interlace {interlace}")
    ch = _CHANNELS[ctype]
    stride = (W * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (1 + stride):
        raise ValueError("PNG image data is truncated")
    rows = _unfilter(raw[: H * (1 + stride)].reshape(H, 1 + stride), H,
                     stride, max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(H, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(axis=2, dtype=np.uint8)[:, :W]
    pixels = rows.reshape(H, W) if ch == 1 else rows.reshape(H, W, ch)
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    return pixels, ctype, palette


def png_encode(arr: np.ndarray, level: int = 1) -> bytes:
    """Encode an (H, W) gray or (H, W, 3) RGB uint8 array as a PNG."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        ctype = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"png_encode: shape {arr.shape} is not (H, W[, 3])")
    H, W = arr.shape[:2]
    rows = arr.reshape(H, -1)
    filt = np.empty((H, 1 + rows.shape[1]), np.uint8)
    filt[:, 0] = 2  # up: each row minus the row above (zeros above row 0)
    filt[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filt[1:, 1:])

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filt.tobytes(), level))
            + chunk(b"IEND", b""))


def _decode_file(path):
    """("png", png_decode result) or ("jpeg", pixels) from the file's first
    bytes (a .png or .jpg name that is neither raises ValueError, as does a
    broken file), or ("pil", what PIL has to read) for the rest."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE or (_is_png(path) and data[:2] != _JPEG_SOI):
        try:
            return "png", png_decode(data)
        except _Unsupported as e:
            return "pil", f"reading {path} (a PNG of {e})"
    if data[:2] == _JPEG_SOI or _is_jpeg(path):
        try:
            return "jpeg", native.jpeg_decode(data)
        except native.JpegUnsupported as e:
            return "pil", f"reading {path} ({e})"
    return "pil", f"reading {path} (neither PNG nor JPEG)"


def _cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB conversion (Convert.c, cmyk2rgb), bitwise: each
    channel nk - c·nk/255 with nk = 255 - k, in PIL's integer rounding."""
    c = px[..., :3].astype(np.int32)
    nk = 255 - px[..., 3:].astype(np.int32)
    t = c * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def load_rgb(path) -> np.ndarray:
    """Load an RGB image as (H, W, 3) uint8 (alpha dropped, gray replicated,
    palette expanded)."""
    kind, got = _decode_file(path)
    if kind == "pil":
        with pil_image(got).open(path) as im:
            return np.array(im if im.mode == "RGB" else im.convert("RGB"))
    if kind == "jpeg":
        if got.ndim == 2:
            return np.repeat(got[..., None], 3, axis=2)
        return _cmyk_to_rgb(got) if got.shape[2] == 4 else got
    px, ctype, palette = got
    if ctype == 3:
        return palette[px]
    if ctype in (0, 4):
        gray = px if ctype == 0 else px[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def load_mask(path) -> np.ndarray:
    """Load a mask as (H, W): palette indices and gray values kept, channel
    0 of a colour image."""
    kind, got = _decode_file(path)
    if kind == "pil":
        with pil_image(got).open(path) as im:
            arr = np.array(im)
        return arr[:, :, 0] if arr.ndim == 3 else arr
    px = got if kind == "jpeg" else got[0]
    return np.ascontiguousarray(px[:, :, 0]) if px.ndim == 3 else px


def image_size(path) -> tuple[int, int]:
    """(H, W) of an image from its header, without decoding the pixels."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] == _SIGNATURE and head[12:16] == b"IHDR":
        W, H = struct.unpack(">II", head[16:24])
        return H, W
    if head[:2] == _JPEG_SOI:
        with open(path, "rb") as f:
            H, W, _ = native.jpeg_info(f.read())
        return H, W
    with pil_image().open(path) as im:
        w, h = im.size
    return h, w


def save_image(path, arr: np.ndarray, quality: int = 75) -> None:
    """Save an (H, W[, 3]) uint8 array: PNGs through png_encode (zlib level
    1), .jpg/.jpeg through the native baseline encoder at `quality`, other
    formats through PIL."""
    arr = np.asarray(arr, dtype=np.uint8)
    plain = arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)
    if plain and (_is_png(path) or _is_jpeg(path)):
        data = png_encode(arr) if _is_png(path) else native.jpeg_encode(
            arr, quality)
        with open(path, "wb") as f:
            f.write(data)
        return
    pil_image().fromarray(arr).save(path)


def mask_to_arap(annot_mask: np.ndarray) -> np.ndarray:
    """Single-segment conversion: background (annot == 0) -> ARAP_BG, object
    -> 0 (the reference's para_gen.py:514-517)."""
    out = np.zeros_like(annot_mask, dtype=np.uint8)
    out[annot_mask == 0] = ARAP_BG
    return out


def segment_mask_to_arap(annot_mask: np.ndarray, segment_id: int) -> np.ndarray:
    """Per-segment conversion for --multseg: segment s -> 0, all else ->
    ARAP_BG (the reference's para_gen.py:526-528)."""
    out = np.full_like(annot_mask, ARAP_BG, dtype=np.uint8)
    out[annot_mask == segment_id] = 0
    return out
