"""PNG reading and writing on the standard library's zlib and struct.

A BOP depth image is 16-bit grayscale and a mask 8-bit grayscale, so
the data layer needs no image library. Read: non-interlaced 8- and
16-bit grayscale and 8-bit RGB, all five row filters (encoders such as
PIL's pick a filter per row), image data split over several IDAT chunks,
chunk CRCs checked. Any other form (palette, alpha, interlace, other bit
depths) raises ValueError naming the file, and so does a JPEG, which
data/jpeg.py reads. Write: the same three forms, unfiltered rows.
Arrays are as PIL gives them: (H, W) uint8 or uint16, (H, W, 3) uint8.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> (channels, numpy dtype on disk)
_FORMS = {(0, 8): (1, np.dtype(np.uint8)), (0, 16): (1, np.dtype(">u2")),
          (2, 8): (3, np.dtype(np.uint8))}


def read_png(path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: a JPEG image; read_png reads PNG only "
                         "(data/jpeg.read_jpeg is the JPEG decoder)")
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: damaged {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE":
            raise ValueError(f"{path}: a palette PNG is not supported")
        elif not kind[0] & 0x20:   # an unknown critical chunk
            raise ValueError(f"{path}: unsupported chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, colour, compression, filt, interlace = header
    if (colour, depth) not in _FORMS or compression or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG form (colour type {colour}, bit depth "
            f"{depth}, interlace {interlace}); the port reads non-interlaced "
            "8/16-bit grayscale and 8-bit RGB")
    channels, dtype = _FORMS[(colour, depth)]
    bpp = channels * dtype.itemsize
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data of {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prior, bpp, path)
        prior = out[y]
    img = out.view(dtype).reshape((h, w, channels) if channels > 1
                                  else (h, w))
    return img.astype(dtype.newbyteorder("="))


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int,
              path) -> np.ndarray:
    """One row's bytes before filter `kind` (PNG spec, section 9)."""
    if kind == 0:
        return line
    if kind == 2:                                   # Up
        return line + prior
    if kind == 1:                                   # Sub: a running sum
        lanes = line.reshape(-1, bpp).astype(np.uint32)  # per byte lane
        return (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).ravel()
    if kind not in (3, 4):
        raise ValueError(f"{path}: unknown PNG row filter {kind}")
    # Average and Paeth read the reconstructed byte to the left: a loop
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    n = len(cur)
    if kind == 3:
        for x in range(n):
            left = cur[x - bpp] if x >= bpp else 0
            cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
    else:
        for x in range(n):
            if x >= bpp:
                a, c = cur[x - bpp], up[x - bpp]
            else:
                a = c = 0
            b = up[x]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[x] = (cur[x] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, array) -> None:
    """Write (H, W) uint8 / uint16 grayscale or (H, W, 3) uint8 RGB."""
    a = np.asarray(array)
    if a.ndim == 2 and a.dtype == np.uint8:
        colour, depth = 0, 8
    elif a.ndim == 2 and a.dtype == np.uint16:
        colour, depth = 0, 16
    elif a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8:
        colour, depth = 2, 8
    else:
        raise ValueError(f"{path}: write_png takes (H, W) uint8 / uint16 or "
                         f"(H, W, 3) uint8, got {a.shape} {a.dtype}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(_FORMS[(colour, depth)][1]))
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    Path(path).write_bytes(
        SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                      0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b""))
