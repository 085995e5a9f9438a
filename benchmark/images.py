"""The benchmark's own image codecs, numpy and the standard library only.

- PNG: 8-bit gray and RGB. ``png_encode`` writes filter 0 ("none") rows;
  ``png_decode`` reads non-interlaced 8-bit gray and RGB with any of the
  five row filters (what the program under test writes).
- JPEG: ``jpeg_encode`` writes baseline JFIF, 4:2:0, at a quality, with the
  standard Huffman tables, as a camera or PIL would. It returns the file
  and the quantised coefficients it wrote. ``jpeg_pixels`` turns those
  coefficients into pixels the way libjpeg-turbo decodes a baseline 4:2:0
  file by default (the ISLOW integer IDCT of jidctint.c, h2v2 "fancy"
  upsampling of jdsample.c, the fixed-point YCbCr→RGB tables of
  jdcolor.c). Huffman coding is lossless, so these are the pixels any
  libjpeg-exact decoder reads from the file; the plain reference takes
  them from here and never decodes the program's inputs itself.

Everything is vectorised over the image, so making the frames of a run
costs a fraction of a second each.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------- PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_encode(arr: np.ndarray, level: int = 1) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes (filter 0)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        ctype = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"png_encode: shape {arr.shape}")
    H, W = arr.shape[:2]
    raw = np.zeros((H, 1 + arr[0].size), np.uint8)
    raw[:, 1:] = arr.reshape(H, -1)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_row(ftype: int, line: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ftype == 0:
        return line
    if ftype == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
    if ftype == 2:
        return line + prior
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
        cur[i] = (cur[i] + (a if pa <= pb and pa <= pc
                            else (b if pb <= pc else c))) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit gray or RGB, not interlaced) -> (H, W[, 3]) uint8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (0, 2) or interlace:
        raise ValueError(f"png_decode: unsupported header {header}")
    ch = 1 if ctype == 0 else 3
    stride = W * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: H * (1 + stride)].reshape(H, 1 + stride)
    if (raw[:, 0] == 2).all():  # every row "up": a running sum down columns
        rows = np.cumsum(raw[:, 1:], axis=0, dtype=np.uint8)
    else:
        rows = np.empty((H, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for y in range(H):
            rows[y] = prior = _unfilter_row(int(raw[y, 0]), raw[y, 1:],
                                            prior, ch)
    return rows.reshape(H, W) if ch == 1 else rows.reshape(H, W, 3)


# --------------------------------------------------------------- JPEG

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

DC_LUMA_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_CHROMA_BITS = [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))
AC_LUMA_BITS = [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]
AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
AC_CHROMA_BITS = [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's quality scaling with force_baseline (natural order)."""
    quality = min(100, max(1, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base.astype(np.int64) * scale + 50) // 100, 1, 255)


def _huff_codes(bits, vals):
    """(code, length) of every symbol of a table given by its counts."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            code[vals[k]] = c
            size[vals[k]] = length
            c += 1
            k += 1
        c <<= 1
    return code, size


_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(PH, PW) -> (PH/8, PW/8, 8, 8)."""
    PH, PW = plane.shape
    return plane.reshape(PH // 8, 8, PW // 8, 8).swapaxes(1, 2)


def _quantise(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level-shifted float DCT of every block, quantised: (by, bx, 64)
    int64 in natural order."""
    b = _blocks(plane - 128.0)
    d = np.einsum("ux,abxy,vy->abuv", _DCT, b, _DCT, optimize=True)
    c = np.round(d.reshape(*d.shape[:2], 64) / q).astype(np.int64)
    c[..., 1:] = np.clip(c[..., 1:], -1023, 1023)
    return c


def _bit_size(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    n = np.zeros(v.shape, np.int64)
    while (a > 0).any():
        n += a > 0
        a >>= 1
    return n


def _block_symbols(zz: np.ndarray, dc_tab, ac_tab):
    """Codes of blocks (n, 64) in zigzag order, in stream order: per block
    the DC difference, the AC run/size symbols (with ZRLs) and an EOB.
    Returns (block, order, code, length) arrays, one row a bit field."""
    n = zz.shape[0]
    out = []
    # DC: one Huffman symbol and the extra bits, differences from the
    # previous block of this component
    diff = np.diff(zz[:, 0], prepend=0)
    s = _bit_size(diff)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    blk = np.arange(n)
    out.append((blk, np.zeros(n, np.int64), dc_tab[0][s], dc_tab[1][s]))
    out.append((blk, np.ones(n, np.int64), extra, s))
    # AC: each nonzero coefficient with the zero run before it
    bi, ki = np.nonzero(zz[:, 1:])
    ki = ki + 1
    first = np.r_[True, bi[1:] != bi[:-1]]
    prev = np.where(first, 0, np.r_[0, ki[:-1]])
    run = ki - prev - 1
    zrl = run // 16
    run = run % 16
    v = zz[bi, ki]
    s = _bit_size(v)
    sym = run * 16 + s
    extra = np.where(v < 0, v - 1, v) & ((1 << s) - 1)
    order = 4 * ki  # slots of a coefficient: ZRLs, symbol, extra bits
    if zrl.any():
        rep = np.repeat(np.arange(len(bi)), zrl)
        out.append((bi[rep], order[rep] - 1, np.full(rep.size, ac_tab[0][0xF0]),
                    np.full(rep.size, ac_tab[1][0xF0])))
    out.append((bi, order, ac_tab[0][sym], ac_tab[1][sym]))
    out.append((bi, order + 1, extra, s))
    # EOB where the last coefficient is zero
    eob = zz[:, 63] == 0
    out.append((blk[eob], np.full(eob.sum(), 1000), np.full(eob.sum(),
               ac_tab[0][0]), np.full(eob.sum(), ac_tab[1][0])))
    return tuple(np.concatenate([o[i] for o in out]) for i in range(4))


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate bit fields MSB first, pad with ones, stuff 0xFF bytes."""
    keep = lengths > 0
    codes, lengths = codes[keep], lengths[keep]
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    owner = np.repeat(np.arange(len(lengths)), lengths)
    pos_in = np.arange(total) - starts[owner]
    bits = (codes[owner] >> (lengths[owner] - 1 - pos_in)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    by = np.packbits(bits)
    ff = np.nonzero(by == 0xFF)[0]
    return np.insert(by, ff + 1, 0).tobytes()


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr, float (H, W, 3)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                     -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                     0.5 * r - 0.418688 * g - 0.081312 * b + 128.0], -1)


def jpeg_encode(rgb: np.ndarray, quality: int = 95):
    """(H, W, 3) uint8 -> (baseline 4:2:0 JFIF bytes, coefficients). The
    coefficients are (Y, Cb, Cr) blocks (by, bx, 64) in natural order,
    quantised, with the two tables (qy, qc); ``jpeg_pixels`` decodes them."""
    rgb = np.asarray(rgb, np.uint8)
    H, W = rgb.shape[:2]
    PH, PW = -(-H // 16) * 16, -(-W // 16) * 16
    pad = np.pad(rgb, ((0, PH - H), (0, PW - W), (0, 0)), mode="edge")
    ycc = rgb_to_ycc(pad)
    qy, qc = quant_table(STD_LUMA, quality), quant_table(STD_CHROMA, quality)
    cy = _quantise(ycc[..., 0], qy)
    sub = ycc[..., 1:].reshape(PH // 2, 2, PW // 2, 2, 2).mean((1, 3))
    cb = _quantise(sub[..., 0], qc)
    cr = _quantise(sub[..., 1], qc)
    # stream order: per 16x16 MCU four Y blocks (2x2), then Cb, then Cr
    my, mx = PH // 16, PW // 16
    yz = cy[..., ZIGZAG].reshape(my, 2, mx, 2, 64).swapaxes(1, 2).reshape(
        -1, 64)
    cbz = cb[..., ZIGZAG].reshape(-1, 64)
    crz = cr[..., ZIGZAG].reshape(-1, 64)
    dcl, acl = _huff_codes(DC_LUMA_BITS, DC_VALS), _huff_codes(AC_LUMA_BITS,
                                                               AC_LUMA_VALS)
    dcc, acc = (_huff_codes(DC_CHROMA_BITS, DC_VALS),
                _huff_codes(AC_CHROMA_BITS, AC_CHROMA_VALS))
    parts = []
    n_mcu = my * mx
    for comp, zz, dct, act in ((0, yz, dcl, acl), (1, cbz, dcc, acc),
                               (2, crz, dcc, acc)):
        b, o, c, ln = _block_symbols(zz, dct, act)
        per = 4 if comp == 0 else 1
        mcu = b // per
        slot = (b % per) if comp == 0 else 3 + comp
        parts.append((mcu * 8 + slot, o, c, ln))
    key_blk, key_ord, codes, lengths = (np.concatenate([p[i] for p in parts])
                                        for i in range(4))
    order = np.lexsort((key_ord, key_blk))
    scan = _pack_bits(codes[order], lengths[order])
    assert n_mcu * 8 > key_blk.max()

    def dht(tc_th, bits, vals):
        return bytes([tc_th]) + bytes(bits[1:]) + bytes(vals)

    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    out += b"\xff\xdb" + struct.pack(">H", 2 + 65 * 2)
    out += bytes([0]) + bytes(qy[ZIGZAG].astype(np.uint8))
    out += bytes([1]) + bytes(qc[ZIGZAG].astype(np.uint8))
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, H, W, 3)
    out += bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    tables = (dht(0x00, DC_LUMA_BITS, DC_VALS) + dht(0x10, AC_LUMA_BITS,
                                                      AC_LUMA_VALS)
              + dht(0x01, DC_CHROMA_BITS, DC_VALS)
              + dht(0x11, AC_CHROMA_BITS, AC_CHROMA_VALS))
    out += b"\xff\xc4" + struct.pack(">H", 2 + len(tables)) + tables
    out += b"\xff\xda" + struct.pack(">HB", 12, 3) + bytes(
        [1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    out += scan + b"\xff\xd9"
    return bytes(out), {"y": cy, "cb": cb, "cr": cr, "qy": qy, "qc": qc,
                        "shape": (H, W)}


# ISLOW IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_pass(x0, x1, x2, x3, x4, x5, x6, x7, first: bool):
    """One 1-D pass of the ISLOW IDCT over int64 arrays; returns the 8
    outputs before descaling (the caller descales)."""
    f = _F
    z1 = (x2 + x6) * f["f0541"]
    tmp2 = z1 + x6 * -f["f1847"]
    tmp3 = z1 + x2 * f["f0765"]
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Blocks (..., 64) of quantised coefficients (natural order) -> (...,
    8, 8) uint8 samples, as libjpeg's jpeg_idct_islow with its range
    limit."""
    d = coef.astype(np.int64) * q.astype(np.int64)
    d = d.reshape(*d.shape[:-1], 8, 8)
    cols = _idct_pass(*(d[..., k, :] for k in range(8)), first=True)
    ws = np.stack([_descale(c, 13 - 2) for c in cols], -2)  # (..., 8 rows, 8)
    rows = _idct_pass(*(ws[..., :, k] for k in range(8)), first=False)
    out = np.stack([_descale(r, 13 + 2 + 3) + 128 for r in rows], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _plane(blocks: np.ndarray) -> np.ndarray:
    """(by, bx, 8, 8) -> (by*8, bx*8)."""
    by, bx = blocks.shape[:2]
    return blocks.swapaxes(1, 2).reshape(by * 8, bx * 8)


def _h2v2_fancy(c: np.ndarray, H: int, W: int) -> np.ndarray:
    """jdsample.c's h2v2_fancy_upsample of a chroma plane (dh, dw) to
    (H, W)."""
    dh, dw = -(-H // 2), -(-W // 2)
    c = c[:dh, :dw].astype(np.int64)
    y = np.arange(H)
    r = y >> 1
    other = np.where(y & 1, np.minimum(r + 1, dh - 1), np.maximum(r - 1, 0))
    cs = c[r] * 3 + c[other]  # (H, dw) column sums
    last = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
    nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
    out = np.empty((H, 2 * dw), np.int64)
    out[:, 0::2] = (cs * 3 + last + 8) >> 4
    out[:, 1::2] = (cs * 3 + nxt + 7) >> 4
    return out[:, :W]


def _color_tables():
    x = np.arange(256) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16,
            (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


def jpeg_pixels(coefs: dict) -> np.ndarray:
    """The (H, W, 3) uint8 pixels libjpeg-turbo's default decode gives for
    the coefficients ``jpeg_encode`` wrote."""
    H, W = coefs["shape"]
    yp = _plane(idct_islow(coefs["y"], coefs["qy"]))[:H, :W].astype(np.int64)
    cb = _h2v2_fancy(_plane(idct_islow(coefs["cb"], coefs["qc"])), H, W)
    cr = _h2v2_fancy(_plane(idct_islow(coefs["cr"], coefs["qc"])), H, W)
    cr_r, cb_b, cr_g, cb_g = _color_tables()
    rgb = np.stack([yp + cr_r[cr], yp + ((cb_g[cb] + cr_g[cr]) >> 16),
                    yp + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
