"""Baseline JPEG decoding for the BOP colour frames (rgb/*.jpg), where the
JAX package reads them with PIL (pose6d_tpu/data/bop.py _load_image).
The card's host has no PIL, so the port decodes them itself.

Covers what BOP renderers and PIL write: sequential Huffman coding
(SOF0, and SOF1 at 8-bit precision), 1 or 3 components, the 4:4:4,
4:2:2 and 4:2:0 samplings, restart markers, one interleaved scan or one
scan per component. A progressive (SOF2), lossless or arithmetic-coded
file, or any other precision or sampling, raises ValueError naming the
file and the coding. Arrays are as PIL gives them: (H, W) uint8 for one
component, (H, W, 3) uint8 RGB for three.

So that the pixels are PIL's, the steps follow libjpeg's defaults as PIL
calls it: the integer "islow" inverse DCT (jidctint.c, 13-bit constants,
2 extra bits between passes, the range limit of its wrapped table), the
"fancy" triangle upsampling of subsampled chroma (jdsample.c,
h2v1_fancy_upsample and h2v2_fancy_upsample with their 1/2 and 8/7
alternating biases, edge rows and columns replicated) and the integer
YCbCr -> RGB conversion of jdcolor.c (16-bit fixed point). The marker
parsing and the transforms are numpy; the bit-serial Huffman decoding of
a scan is C++ (native/jpeg.cpp).
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

# frame markers by their coding; SOF0 / SOF1 are what this module reads
_CODINGS = {0xC0: "baseline", 0xC1: "extended sequential",
            0xC2: "progressive", 0xC3: "lossless",
            0xC5: "differential sequential", 0xC6: "differential progressive",
            0xC7: "differential lossless", 0xC9: "arithmetic sequential",
            0xCA: "arithmetic progressive", 0xCB: "arithmetic lossless",
            0xCD: "arithmetic differential sequential",
            0xCE: "arithmetic differential progressive",
            0xCF: "arithmetic differential lossless"}
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SCAN_ERRORS = {-1: "bad Huffman table", -2: "bad entropy-coded data",
                -3: "missing restart marker"}

# jidctint.c
_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: v for name, v in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7, shift):
    """One jidctint.c pass over int64 arrays (x_i the i-th input of each
    8-point row or column); the outputs descaled by `shift` bits."""
    z1 = (x2 + x6) * _F["0_541196100"]
    tmp2 = z1 - x6 * _F["1_847759065"]
    tmp3 = z1 + x2 * _F["0_765366865"]
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefs, qt):
    """(..., 64) quantized coefficients (natural order) and a (64,)
    quantization table -> (..., 8, 8) uint8 samples, as jpeg_idct_islow
    computes them."""
    c = coefs.astype(np.int64) * qt.astype(np.int64)
    c = c.reshape(*c.shape[:-1], 8, 8)
    # pass 1: columns (its all-AC-zero shortcut gives the same values)
    cols = _idct_1d(*(c[..., i, :] for i in range(8)),
                    shift=_CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=-2)
    rows = _idct_1d(*(ws[..., :, i] for i in range(8)),
                    shift=_CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=-1)
    # libjpeg's post-IDCT range limit: the value wraps modulo 1024 as a
    # signed 10-bit number, then centres and clamps
    wrapped = ((out + 512) & 1023) - 512
    return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


def _upsample_h2(x):
    """h2v1_fancy_upsample along the last axis (int64 in, int64 out)."""
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    if x.shape[-1] == 1:
        even, odd = x, x
    else:
        even[..., 0] = x[..., 0]
        odd[..., -1] = x[..., -1]
    return np.stack([even, odd], axis=-1).reshape(*x.shape[:-1], -1)


def _upsample_h2v2(x):
    """h2v2_fancy_upsample of an (h, w) plane: each output row pair from
    its row and the row above / below (3:1), then columns (3:1), with
    the biases 8 and 7."""
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for v, near in ((0, above), (1, below)):
        s = 3 * x + near                          # the column sums
        prev = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        nxt = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        even = (3 * s + prev + 8) >> 4
        odd = (3 * s + nxt + 7) >> 4
        even[:, 0] = (4 * s[:, 0] + 8) >> 4
        odd[:, -1] = (4 * s[:, -1] + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert on int64 planes -> (H, W, 3) uint8."""
    one_half = 1 << 15
    cbx, crx = cb - 128, cr - 128
    r = y + ((91881 * crx + one_half) >> 16)          # FIX(1.40200)
    b = y + ((116130 * cbx + one_half) >> 16)         # FIX(1.77200)
    g = y + ((-22554 * cbx + one_half - 46802 * crx) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _segment(data: bytes, pos: int, path):
    """The marker segment at `pos`: (marker, payload, position after
    it). Standalone markers (SOI, EOI, RSTn, TEM) have no payload; fill
    bytes (FF FF) are skipped."""
    while pos + 1 < len(data) and data[pos] == 0xFF and data[pos + 1] == 0xFF:
        pos += 1
    if pos + 1 >= len(data):
        raise ValueError(f"{path}: truncated JPEG (no EOI)")
    if data[pos] != 0xFF:
        raise ValueError(f"{path}: JPEG marker expected at byte {pos}")
    marker = data[pos + 1]
    pos += 2
    if marker in (0xD8, 0xD9, 0x01) or 0xD0 <= marker <= 0xD7:
        return marker, b"", pos
    n, = struct.unpack(">H", data[pos:pos + 2])
    return marker, data[pos + 2:pos + n], pos + n


def read_jpeg(path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qts = {}
    huff_counts = np.zeros((8, 16), np.uint8)
    huff_symbols = np.zeros((8, 256), np.uint8)
    frame, restart, adobe_transform = None, 0, None
    pos = 2
    while True:
        marker, body, pos = _segment(data, pos, path)
        if marker == 0xD9:
            break
        if marker in _CODINGS:
            if marker not in (0xC0, 0xC1):
                raise ValueError(f"{path}: {_CODINGS[marker]} JPEG is not "
                                 "read (baseline sequential Huffman only)")
            frame = _frame(body, path)
        elif marker == 0xDB:
            _tables_dqt(body, qts, path)
        elif marker == 0xC4:
            _tables_dht(body, huff_counts, huff_symbols, path)
        elif marker == 0xDD:
            restart, = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            pos += _scan(data[pos:], body, frame, huff_counts, huff_symbols,
                         restart, path)
    if frame is None:
        raise ValueError(f"{path}: no frame header")
    return _pixels(frame, qts, adobe_transform, path)


def _frame(body, path) -> dict:
    precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit JPEG is not read")
    if ncomp not in (1, 3) or height == 0:
        raise ValueError(f"{path}: JPEG with {ncomp} components or no "
                         "height is not read")
    comps = []
    for i in range(ncomp):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        if (hmax // c["h"], vmax // c["v"]) not in ((1, 1), (2, 1), (2, 2)) \
                or hmax % c["h"] or vmax % c["v"]:
            raise ValueError(f"{path}: JPEG sampling {c['h']}x{c['v']} of "
                             f"{hmax}x{vmax} is not read (4:4:4, 4:2:2, "
                             "4:2:0 only)")
        c["w"] = -(-width * c["h"] // hmax)           # downsampled size
        c["hgt"] = -(-height * c["v"] // vmax)
        c["bx"], c["by"] = mcux * c["h"], mcuy * c["v"]
        c["coefs"] = np.zeros((c["by"], c["bx"], 64), np.int16)
    return {"width": width, "height": height, "comps": comps,
            "hmax": hmax, "vmax": vmax, "mcux": mcux, "mcuy": mcuy}


def _tables_dqt(body, qts, path):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        n = 64 * (1 + pq)
        vals = np.frombuffer(body[i + 1:i + 1 + n],
                             ">u2" if pq else np.uint8).astype(np.int64)
        if len(vals) != 64:
            raise ValueError(f"{path}: truncated quantization table")
        qt = np.zeros(64, np.int64)
        qt[_ZIGZAG] = vals
        qts[tq] = qt
        i += 1 + n


def _tables_dht(body, counts, symbols, path):
    i = 0
    while i < len(body):
        tc, th = body[i] >> 4, body[i] & 15
        if tc > 1 or th > 3:
            raise ValueError(f"{path}: bad Huffman table id")
        slot = 4 * tc + th
        c = np.frombuffer(body[i + 1:i + 17], np.uint8)
        n = int(c.sum())
        counts[slot] = c
        symbols[slot] = 0
        symbols[slot, :n] = np.frombuffer(body[i + 17:i + 17 + n], np.uint8)
        i += 17 + n


def _scan(rest, body, frame, huff_counts, huff_symbols, restart, path):
    """Decode one scan from `rest` (the bytes after its header); returns
    the bytes it took."""
    from ..native import library
    ns = body[0]
    if body[1 + 2 * ns] != 0 or body[2 + 2 * ns] != 63 or body[3 + 2 * ns]:
        raise ValueError(f"{path}: a spectral-selection or successive-"
                         "approximation scan (progressive) is not read")
    by_id = {c["id"]: c for c in frame["comps"]}
    comps, dc, ac = [], [], []
    for j in range(ns):
        c = by_id[body[1 + 2 * j]]
        comps.append(c)
        dc.append(body[2 + 2 * j] >> 4)
        ac.append(body[2 + 2 * j] & 15)
    # a one-component scan walks that component's own block extent
    nbx = [-(-c["w"] // 8) for c in comps]
    nby = [-(-c["hgt"] // 8) for c in comps]

    def arr(vals, t=ctypes.c_int32):
        return (t * len(vals))(*vals)

    buf = np.frombuffer(rest, np.uint8)
    ptrs = (ctypes.c_void_p * ns)(*(c["coefs"].ctypes.data for c in comps))
    took = library("jpeg").jpeg_decode_scan(
        buf.ctypes.data, len(buf), ns, ptrs,
        arr([c["bx"] for c in comps]), arr([c["h"] for c in comps]),
        arr([c["v"] for c in comps]), arr(dc), arr(ac), arr(nbx), arr(nby),
        huff_counts.ctypes.data, huff_symbols.ctypes.data, frame["mcux"],
        frame["mcuy"], restart)
    if took < 0:
        why = _SCAN_ERRORS.get(took, str(took))
        raise ValueError(f"{path}: corrupt JPEG scan ({why})")
    return took


def _pixels(frame, qts, adobe_transform, path) -> np.ndarray:
    planes = []
    for c in frame["comps"]:
        if c["tq"] not in qts:
            raise ValueError(f"{path}: missing quantization table {c['tq']}")
        blocks = idct_islow(c["coefs"], qts[c["tq"]])      # (by, bx, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(8 * c["by"], 8 * c["bx"])
        plane = plane[:c["hgt"], :c["w"]].astype(np.int64)
        ratio = (frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        if ratio == (2, 1):
            plane = _upsample_h2(plane)
        elif ratio == (2, 2):
            plane = _upsample_h2v2(plane)
        planes.append(plane[:frame["height"], :frame["width"]])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c["id"] for c in frame["comps"])
    if adobe_transform == 0 or (adobe_transform is None
                                and ids == (82, 71, 66)):   # 'R', 'G', 'B'
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)
