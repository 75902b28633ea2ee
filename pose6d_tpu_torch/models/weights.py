"""flax msgpack checkpoints <-> the port's modules, and flax's init.

(a) read_flax_msgpack: a pure-Python reader of the msgpack format that
    flax.serialization writes (maps, str/bin, and ext type 1 = a packed
    (shape, dtype name, bytes) ndarray); no flax and no msgpack package
    needed. write_flax_msgpack is its mirror: the same bytes that
    flax.serialization.to_bytes gives for the same tree (keys in the
    dict's own order, as to_bytes keeps them).
(b) state_dict_from_flax: maps the params tree onto DPFMNet's
    state_dict. The torch submodules carry the flax scope names, so the
    map is mechanical: a Dense kernel (in, out) becomes a Linear weight
    (out, in); biases and diffusion_time are copied as they are.
    flax_from_state_dict is the inverse.
(c) load_flax_checkpoint: (a) then (b); save_flax_params: the inverse,
    a {"params": ...} file that the JAX package loads.
(d) init_like_flax: a fresh model drawn as flax's defaults draw it
    (lecun normal Dense kernels, zero biases and diffusion times).
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


def _pack(obj) -> bytes:
    """msgpack encoding of a params tree as flax writes it."""
    if isinstance(obj, dict):
        n = len(obj)
        head = (bytes([0x80 | n]) if n < 16 else
                b"\xde" + n.to_bytes(2, "big") if n < 1 << 16 else
                b"\xdf" + n.to_bytes(4, "big"))
        return head + b"".join(_pack(str(k)) + _pack(v)
                               for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        head = (bytes([0x90 | n]) if n < 16 else
                b"\xdc" + n.to_bytes(2, "big") if n < 1 << 16 else
                b"\xdd" + n.to_bytes(4, "big"))
        return head + b"".join(_pack(x) for x in obj)
    if isinstance(obj, str):
        b = obj.encode()
        n = len(b)
        head = (bytes([0xa0 | n]) if n < 32 else
                b"\xd9" + bytes([n]) if n < 1 << 8 else
                b"\xda" + n.to_bytes(2, "big") if n < 1 << 16 else
                b"\xdb" + n.to_bytes(4, "big"))
        return head + b
    if isinstance(obj, bytes):
        n = len(obj)
        head = (b"\xc4" + bytes([n]) if n < 1 << 8 else
                b"\xc5" + n.to_bytes(2, "big") if n < 1 << 16 else
                b"\xc6" + n.to_bytes(4, "big"))
        return head + obj
    if isinstance(obj, int) and obj >= 0:
        if obj < 0x80:
            return bytes([obj])
        for code, width in ((0xcc, 1), (0xcd, 2), (0xce, 4), (0xcf, 8)):
            if obj < 1 << (8 * width):
                return bytes([code]) + obj.to_bytes(width, "big")
    if isinstance(obj, np.ndarray):                          # ext type 1
        data = _pack((list(obj.shape), obj.dtype.name, obj.tobytes("C")))
        n = len(data)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        head = (bytes([fixext[n]]) if n in fixext else
                b"\xc7" + bytes([n]) if n < 1 << 8 else
                b"\xc8" + n.to_bytes(2, "big") if n < 1 << 16 else
                b"\xc9" + n.to_bytes(4, "big"))
        return head + b"\x01" + data
    raise TypeError(f"cannot pack {type(obj).__name__}")


def write_flax_msgpack(path, tree: dict) -> None:
    """Write a nested dict of numpy arrays as flax.serialization does."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(_pack(tree))


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


def flax_from_state_dict(state_dict: dict) -> dict:
    """DPFMNet state_dict -> flax params tree (numpy f32): the inverse
    of state_dict_from_flax."""
    tree: dict = {}
    for name, t in state_dict.items():
        *scopes, leaf = name.split(".")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node[leaf] = arr
    return tree


def load_flax_checkpoint(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flax msgpack checkpoint into `model` (strict)."""
    tree = read_flax_msgpack(path)
    model.load_state_dict(state_dict_from_flax(tree["params"]), strict=True)
    return model


def save_flax_params(path, model: torch.nn.Module) -> None:
    """Write the model's parameters as a flax {"params": ...} msgpack
    file (pose6d_tpu.train.checkpoint.load_params reads it)."""
    write_flax_msgpack(path, {"params": flax_from_state_dict(
        model.state_dict())})


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# a normal truncated at +-2 std whose std is divided by the std of the
# unit normal truncated there, so the draws have variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(model: torch.nn.Module,
                   generator: torch.Generator) -> torch.nn.Module:
    """Draw every Linear weight as flax's default Dense init does and
    zero every bias and diffusion_time, in module order."""
    for module in model.modules():
        if isinstance(module, torch.nn.Linear):
            std = (1.0 / module.in_features) ** 0.5 / _TRUNC_STD
            torch.nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std,
                                        2 * std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("diffusion_time"):
            p.zero_()
    return model
