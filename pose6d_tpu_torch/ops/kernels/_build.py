"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``pose6d_tpu_torch/csrc/`` is compiled on first use
into ``build/pose6d_tpu_torch_kernels/`` at the repository root, for
``sm_90a``, as a shared library with a plain C interface. The library
name carries a hash of the source, so an edited source is rebuilt and
an unchanged one is reused. Nothing here runs at import time: a host
without CUDA never reaches the build (each op's CPU implementation is
its plain version, and only its CUDA implementation asks for a
library).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
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
        "masked_topk_cdist_splits": [_I, _I, _I, _I, _I, _I],
        "masked_topk_cdist_wide_smem": [_I, _I],
        "masked_topk_cdist_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _L, _L, _L, _L, _L, _P]},
    "consistency_rank_major.cu": {
        "consistency_rank_major_tiles": [_P],
        "consistency_rank_major_sqrt_check": [_P, _P],
        "consistency_sum_rank_major_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _P],
        "consistency_sum_rank_major_wide_f32": [_P, _P, _P, _P, _P, _P, _I,
                                                _I, _I, _I, _I, _P]},
    "masked_consistency_sum.cu": {
        "masked_consistency_tiles": [_P],
        "masked_consistency_sum_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _P],
        "masked_consistency_sum_wide_f32": [_P, _P, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _P]},
    "flash_cross_attention.cu": {
        "flash_cross_attention_tiles": [_I, _I, _P],
        "flash_cross_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _F, _I, _P]},
    "flash_cross_attention_bwd.cu": {
        "flash_cross_attention_bwd_tiles": [_I, _I, _I, _P],
        "flash_cross_attention_bwd_mma_rate": [_I, _I, _P, _P],
        "flash_cross_attention_bwd_f32": [_P] * 15 + [_I] * 7 + [_F, _P]},
    "ransac_inlier_counts.cu": {
        "ransac_inlier_counts_tiles": [_P],
        "ransac_inlier_counts_f32": [_P] * 8 + [_I] * 4 + [_P]},
    "icp_kabsch_update.cu": {
        "icp_kabsch_update_f32": [_P] * 11 + [_I] * 3 + [_P]},
}

# launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES = {"flash_cross_attention": 0, "flash_cross_attention_backward": 0,
            "consistency_sum_rank_major": 0, "masked_consistency_sum": 0,
            "masked_topk_cdist": 0, "masked_argmin_cdist": 0,
            "ransac_inlier_counts": 0, "icp_kabsch_update": 0}

# launches split by kernel instance, counted beside LAUNCHES: {(kernel,
# *instance): launches}; the flash kernels' instance is the caller's
# (head dim, heads), the cdist kernels' (K, route) with route "tiled"
# (C <= 64), "chunked" (C > 64), or for k > 16 "wide" (the rows'
# distances in shared memory) or "wide_walk" (recomputed), the
# rank-major kernel's (k,) at 3-D endpoints and (k, "C<width>") at other
# widths, the PC-major kernel's ("C<width>",) at widths other than 3
LAUNCHES_BY_INSTANCE: dict[tuple, int] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_INSTANCE.clear()


def instance_label(key: tuple) -> str:
    """'kernel a x b' for a LAUNCHES_BY_INSTANCE key (kernel, a, b)."""
    return f"{key[0]} " + "x".join(str(x) for x in key[1:])


def count_launch(name: str, instance: tuple | None = None) -> None:
    """One launch of kernel `name` (and of its `instance`, if given)."""
    LAUNCHES[name] += 1
    if instance is not None:
        key = (name, *instance)
        LAUNCHES_BY_INSTANCE[key] = LAUNCHES_BY_INSTANCE.get(key, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(source: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers (csrc/*.cuh) and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:12]}.so"


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    return _sm_count(torch.device(device).index or 0)


def segment_tiles(tiles: int, segments: int, s: int) -> range:
    """The tiles of segment s when a kernel splits its walk over `tiles`
    tiles into `segments` segments across blocks: interleaved (s, s + S,
    ...), so that live rows or keys that form a prefix spread over every
    segment."""
    return range(s, tiles, segments)


def plan_segments(blocks: int, tiles: int, sms: int, blocks_per_sm: int,
                  least: int = 1) -> int:
    """The number of segments G that a kernel with `blocks` blocks per
    segment, walking `tiles` tiles, splits its walk into, on `sms` SMs
    that hold `blocks_per_sm` of its blocks each. G is at least enough
    for two blocks on every SM (and `least`), at most one segment per
    tile, and up to twice that or 8; among those, the G with the fewest
    tile-times: waves of blocks x (tiles of the longest segment + one
    for the block's set-up and its share of the merge), the smallest on
    a tie."""
    fill = -(-2 * sms // blocks)
    lo = max(1, least, min(fill, tiles))
    hi = max(lo, min(tiles, max(2 * fill, 8)))
    slots = sms * blocks_per_sm
    return min(range(lo, hi + 1),
               key=lambda g: (-(-blocks * g // slots) * (-(-tiles // g) + 1),
                              g))


_TILES: dict = {}


def kernel_tiles(fn, expected: tuple, what: str, *args) -> int:
    """Ask a kernel for its tiling once (`fn(*args, out)` writes the
    tiles the wrapper plans with, then the blocks per SM the card holds,
    and returns a CUDA error code); raise unless the tiles are
    `expected`. Returns the blocks per SM."""
    key = (what, args)
    if key not in _TILES:
        out = (ctypes.c_int * (len(expected) + 1))()
        check(fn(*args, ctypes.cast(out, ctypes.c_void_p)), what)
        if tuple(out)[:-1] != tuple(expected):
            raise RuntimeError(f"{what}: kernel tiles {tuple(out)[:-1]}, "
                               f"wrapper plans with {tuple(expected)}")
        _TILES[key] = out[len(expected)]
    return _TILES[key]
