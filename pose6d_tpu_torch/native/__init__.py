"""ctypes bindings of the port's native (C++) host code: QEM decimation
(a port of pose6d_tpu/native/__init__.py) and the JPEG entropy decoder
of data/jpeg.py.

Each source (``decimate.cpp``, ``jpeg.cpp``) is compiled with g++ on
first use into ``build/pose6d_tpu_torch_native/`` at the repository root
(never into the package), under a name that carries a hash of the source
and the flags. A failed build raises with the compiler's output: nothing
falls back silently (``decimate_mesh(..., use_native=False)`` asks for
the Python decimation).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "decimate.cpp"      # the copy of the JAX package's source
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "pose6d_tpu_torch_native"
# the JAX package's Makefile flags: the same compiler gives the same bits
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_PD = ctypes.POINTER(ctypes.c_double)
_PI64 = ctypes.POINTER(ctypes.c_int64)
# source stem -> {C function: (restype, argtypes)}
SOURCES = {
    "decimate": {"decimate_qem": (ctypes.c_int, [
        _PD, _I64, _PI64, _I64, _I64, _PD, _PI64, _PI64, _PI64])},
    "jpeg": {"jpeg_decode_scan": (_I64, [
        _P, _I64, ctypes.c_int] + [_P] * 10 + [_I32, _I32, _I32])},
}

# what each library does, for the build's error messages
LABELS = {"decimate": "decimation", "jpeg": "JPEG decoding"}

_lib = None          # the decimation library, once loaded
_libs: dict = {}     # the others, by source stem
_lock = threading.Lock()


def _target(name: str) -> Path:
    h = hashlib.sha256((HERE / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _build(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: parallel cache workers may build
    # at the same time
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cxx = os.environ.get("CXX", "g++")
    try:
        res = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(HERE / f"{name}.cpp")],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native {LABELS[name]}: cannot run {cxx}: {e}") \
            from e
    if res.returncode != 0:
        raise RuntimeError(f"native {LABELS[name]}: {cxx} failed "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)


def _open(name: str) -> ctypes.CDLL:
    target = _target(name)
    if not target.exists():
        _build(name, target)
    lib = ctypes.CDLL(str(target))
    for fn, (restype, argtypes) in SOURCES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of native/<name>.cpp, built on first use."""
    global _lib
    with _lock:
        if name == "decimate":
            if _lib is None:
                _lib = _open(name)
            return _lib
        if name not in _libs:
            _libs[name] = _open(name)
        return _libs[name]


def decimate_qem(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """(V', 3) float64 vertices and (F', 3) int64 faces after collapsing
    edges until at most target_faces faces remain."""
    lib = library("decimate")
    verts = np.ascontiguousarray(verts, np.float64)
    faces = np.ascontiguousarray(faces, np.int64)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 \
            or faces.shape[1] != 3:
        raise ValueError(f"decimate_qem: verts (V, 3) and faces (F, 3), "
                         f"got {verts.shape} and {faces.shape}")
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("decimate_qem: a face index is out of range")
    nv, nf = len(verts), len(faces)
    out_verts = np.empty_like(verts)
    out_faces = np.empty_like(faces)
    out_nv = ctypes.c_int64()
    out_nf = ctypes.c_int64()
    rc = lib.decimate_qem(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nv,
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nf,
        target_faces,
        out_verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(out_nv), ctypes.byref(out_nf))
    if rc != 0:
        raise RuntimeError(f"decimate_qem failed rc={rc}")
    return (out_verts[:out_nv.value].copy(),
            out_faces[:out_nf.value].copy())
