"""A reader of the msgpack files that flax.serialization writes for a
params tree: maps, arrays, str, bin, unsigned ints and ext type 1 (a
packed (shape, dtype name, bytes) ndarray). The reference's own copy,
so that the reference reads the weights file without the program.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


class _Reader:
    """The msgpack subset that flax.serialization writes for a params
    tree: maps, arrays, str, bin, unsigned ints and ext type 1 (ndarray,
    itself a packed (shape, dtype name, bytes) triple)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7f:                                        # fixint
            return t
        if t <= 0x8f or t in (0xde, 0xdf):                   # map
            n = t & 0x0f if t <= 0x8f else self.uint(2 if t == 0xde else 4)
            return {self.read(): self.read() for _ in range(n)}
        if t <= 0x9f or t in (0xdc, 0xdd):                   # array
            n = t & 0x0f if t <= 0x9f else self.uint(2 if t == 0xdc else 4)
            return [self.read() for _ in range(n)]
        if t <= 0xbf:                                        # fixstr
            return self.take(t & 0x1f).decode()
        if t in (0xd9, 0xda, 0xdb):                          # str 8/16/32
            return self.take(self.uint(1 << (t - 0xd9))).decode()
        if t in (0xc4, 0xc5, 0xc6):                          # bin 8/16/32
            return self.take(self.uint(1 << (t - 0xc4)))
        if t in (0xcc, 0xcd, 0xce, 0xcf):                    # uint 8..64
            return self.uint(1 << (t - 0xcc))
        if t in (0xc7, 0xc8, 0xc9):                          # ext 8/16/32
            n = self.uint(1 << (t - 0xc7))
            code = self.take(1)[0]
            if code != 1:
                raise ValueError(f"unsupported msgpack ext type {code}")
            shape, dtype, buf = _Reader(self.take(n)).read()
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def read_params(path) -> dict:
    """The "params" tree of a flax msgpack file: nested dicts of numpy
    arrays."""
    return _Reader(Path(path).read_bytes()).read()["params"]
