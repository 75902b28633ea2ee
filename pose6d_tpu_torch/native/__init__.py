"""ctypes binding of the port's native (C++) decimation (port of
pose6d_tpu/native/__init__.py).

``decimate.cpp`` is compiled with g++ on first use into
``build/pose6d_tpu_torch_native/`` at the repository root (never into
the package), under a name that carries a hash of the source and the
flags. A failed build raises with the compiler's output: nothing falls
back to the Python decimation silently (``decimate_mesh(...,
use_native=False)`` asks for it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decimate.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "pose6d_tpu_torch_native"
# the JAX package's Makefile flags: the same compiler gives the same bits
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lib = None
_lock = threading.Lock()


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdecimate_{h.hexdigest()[:12]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: parallel cache workers may build
    # at the same time
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cxx = os.environ.get("CXX", "g++")
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native decimation: cannot run {cxx}: {e}") \
            from e
    if res.returncode != 0:
        raise RuntimeError(f"native decimation: {cxx} failed "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            lib.decimate_qem.restype = ctypes.c_int
            lib.decimate_qem.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
        return _lib


def decimate_qem(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """(V', 3) float64 vertices and (F', 3) int64 faces after collapsing
    edges until at most target_faces faces remain."""
    lib = _load()
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
