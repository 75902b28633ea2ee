"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``pose6d_tpu_torch/csrc/`` is compiled on first use
into ``build/pose6d_tpu_torch_kernels/`` at the repository root, for
``sm_90a``, as a shared library with a plain C interface. The library
name carries a hash of the source, so an edited source is rebuilt and
an unchanged one is reused. Nothing here runs at import time: a host
without CUDA never reaches the build (the wrappers take their plain
versions for CPU tensors before they ask for a library).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "pose6d_tpu_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source file -> {C function: argtypes}; c_void_p for pointers and the
# stream (a bare int would be cut to 32 bits), c_int / c_float for scalars,
# c_longlong for strides
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SOURCES = {
    "masked_cdist.cu": {
        "masked_topk_cdist_splits": [_I, _I, _I, _I, _I],
        "masked_topk_cdist_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _L, _L, _L, _L, _L, _P]},
    "consistency_rank_major.cu": {
        "consistency_sum_rank_major_f32": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "masked_consistency_sum.cu": {
        "masked_consistency_sum_f32": [_P, _P, _P, _P, _I, _I, _P]},
    "flash_cross_attention.cu": {
        "flash_cross_attention_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _F, _P]},
    "flash_cross_attention_bwd.cu": {
        "flash_cross_attention_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _F,
                                          _P]},
}

# launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES = {"flash_cross_attention": 0, "flash_cross_attention_backward": 0,
            "consistency_sum_rank_major": 0, "masked_consistency_sum": 0,
            "masked_topk_cdist": 0, "masked_argmin_cdist": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}_{digest[:12]}.so"


def _start(source: str):
    """Start nvcc for `source` unless its library exists; returns
    (target, process or None)."""
    target = _target(source)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return target, (proc, tmp)


def _finish(source: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n"
                           + target.with_suffix(".log").read_text())
    os.replace(tmp, target)


def build_all() -> dict[str, str]:
    """Compile every source at once (one nvcc each, all started
    together); returns {source: ptxas report}."""
    jobs = {src: _start(src) for src in SOURCES}
    reports = {}
    for src, (target, job) in jobs.items():
        _finish(src, target, job)
        log = target.with_suffix(".log")
        reports[src] = log.read_text() if log.exists() else ""
    return reports


def library(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built on first use."""
    lib = _LIBS.get(source)
    if lib is None:
        target, job = _start(source)
        _finish(source, target, job)
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in SOURCES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
