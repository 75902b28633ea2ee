"""flax msgpack checkpoints -> the port's modules.

(a) read_flax_msgpack: a pure-Python reader of the msgpack format that
    flax.serialization writes (maps, str/bin, and ext type 1 = a packed
    (shape, dtype name, bytes) ndarray); no flax and no msgpack package
    needed.
(b) state_dict_from_flax: maps the params tree onto DPFMNet's
    state_dict. The torch submodules carry the flax scope names, so the
    map is mechanical: a Dense kernel (in, out) becomes a Linear weight
    (out, in); biases and diffusion_time are copied as they are.
(c) load_flax_checkpoint: (a) then (b).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


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


def read_flax_msgpack(path) -> dict:
    """The nested dict of numpy arrays in a flax msgpack file."""
    return _Reader(Path(path).read_bytes()).read()


def state_dict_from_flax(params: dict) -> dict:
    """flax params tree (the contents of the top-level "params" key) ->
    DPFMNet state_dict."""
    out = {}

    def walk(tree, prefix):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, prefix + name + ".")
                continue
            t = torch.from_numpy(np.array(leaf, np.float32))
            if name == "kernel":
                out[prefix + "weight"] = t.T.contiguous()
            else:
                out[prefix + name] = t

    walk(params, "")
    return out


def load_flax_checkpoint(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flax msgpack checkpoint into `model` (strict)."""
    tree = read_flax_msgpack(path)
    model.load_state_dict(state_dict_from_flax(tree["params"]), strict=True)
    return model
