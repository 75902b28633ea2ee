"""Spatial-consistency sums (kernels: csrc/consistency_rank_major.cu,
csrc/masked_consistency_sum.cu).

Ports of pose6d_tpu/ops/pallas/consistency.py:80
consistency_sum_rank_major (the PC side read from a (V2, V2) table)
and :136 masked_consistency_sum (both endpoints explicit, PC-major).
For a CUDA tensor each wrapper launches its hand-written kernel; for a
CPU tensor it runs the plain PyTorch version beside it.
"""
from __future__ import annotations

import torch

from ..geometry import pairwise_sqdist
from . import _build

# csrc/consistency_rank_major.cu's tiling (the wrapper checks it against
# the built kernel): PC columns per block, PC rows per staged tile, column
# ranks per block at most; and the ranks it takes
RM_COL_TILE, RM_ROW_TILE, RM_RANKS_PER_BLOCK = 64, 32, 5
RM_MAX_K = 16
_RM_WIDE = ("rank-major consistency sums on the card take k <= "
            f"{RM_MAX_K} ranks (ROADMAP.md, section 2, row 2)")


def rank_major_chunks(k: int) -> int:
    """The chunks of column ranks one launch over k ranks takes: each
    block owns at most RM_RANKS_PER_BLOCK ranks."""
    return -(-k // RM_RANKS_PER_BLOCK)


def rank_major_segments(bsz: int, v2: int, sms: int, blocks_per_sm: int,
                        k: int = 5) -> int:
    """The number of row segments S the rank-major kernel splits its row
    walk into (_build.plan_segments over its column blocks x rank chunks
    x B and its row tiles): at least two blocks on each of `sms` SMs.
    Segment s takes the row tiles _build.segment_tiles(tiles, S, s)."""
    return _build.plan_segments(
        -(-v2 // RM_COL_TILE) * rank_major_chunks(k) * bsz,
        -(-v2 // RM_ROW_TILE), sms, blocks_per_sm)


def rank_major_segments_on(device, bsz: int, v2: int, k: int = 5) -> int:
    """rank_major_segments for the built kernel on the card `device` (its
    tiling and blocks per SM asked from the library once)."""
    per_sm = _build.kernel_tiles(
        _build.library("consistency_rank_major.cu").consistency_rank_major_tiles,
        (RM_COL_TILE, RM_ROW_TILE, RM_RANKS_PER_BLOCK),
        "consistency_sum_rank_major")
    return rank_major_segments(bsz, v2, _build.sm_count(device), per_sm, k)


# csrc/masked_consistency_sum.cu's tiling (checked against the built
# kernel): columns per block, rows per staged tile
PCM_COL_TILE, PCM_ROW_TILE = 256, 256


def consistency_segments(bsz: int, p: int, sms: int,
                         blocks_per_sm: int) -> int:
    """The number of row segments S the PC-major kernel splits its row
    walk into (_build.plan_segments over its column blocks x B and its
    row tiles): at least two blocks on each of `sms` SMs. Segment s
    takes the row tiles _build.segment_tiles(tiles, S, s)."""
    return _build.plan_segments(-(-p // PCM_COL_TILE) * bsz,
                                -(-p // PCM_ROW_TILE), sms, blocks_per_sm)


def consistency_segments_on(device, bsz: int, p: int) -> int:
    """consistency_segments for the built kernel on the card `device`
    (its tiling and blocks per SM asked from the library once)."""
    per_sm = _build.kernel_tiles(
        _build.library("masked_consistency_sum.cu").masked_consistency_tiles,
        (PCM_COL_TILE, PCM_ROW_TILE), "masked_consistency_sum")
    return consistency_segments(bsz, p, _build.sm_count(device), per_sm)


def consistency_sum_rank_major_plain(coords_cad, dpc, w, v2: int):
    """sum_i w_i * |d_cad(i, j) - dpc(i mod v2, j mod v2)| per pair j,
    one frame at a time (the (P, P) tables are 420 MB at P = 10240)."""
    k = coords_cad.shape[1] // v2
    out = []
    for ca, dp, wf in zip(coords_cad, dpc, w):
        da = torch.sqrt(pairwise_sqdist(ca, ca))
        out.append(wf @ torch.abs(da - dp.repeat(k, k)))
    return torch.stack(out)


def consistency_sum_rank_major(coords_cad, dpc, w, v2: int):
    """coords_cad (B, P, 3) rank-major pair endpoints (P = k * v2), dpc
    (B, v2, v2) f32 PC point-distance table, w (B, P) f32 row weights.
    Returns (B, P) f32 sums. The card takes k = 1 to 16."""
    if coords_cad.device.type == "cpu":
        return consistency_sum_rank_major_plain(coords_cad, dpc, w, v2)
    if coords_cad.device.type != "cuda":
        raise ValueError(f"unsupported device {coords_cad.device}")
    bsz, p, c = coords_cad.shape
    if c != 3 or v2 < 1 or p % v2:
        raise ValueError(f"kernel takes (B, k * v2, 3): "
                         f"{tuple(coords_cad.shape)}, v2={v2}")
    k = p // v2
    if not 1 <= k <= RM_MAX_K:
        raise ValueError(f"{_RM_WIDE}: k={k}")
    if dpc.shape != (bsz, v2, v2) or w.shape != (bsz, p):
        raise ValueError(f"bad shapes dpc{tuple(dpc.shape)} w{tuple(w.shape)}")
    if any(t.dtype != torch.float32 for t in (coords_cad, dpc, w)):
        raise TypeError("coords_cad, dpc, w must be float32")
    if not (dpc.device == w.device == coords_cad.device):
        raise ValueError("coords_cad, dpc, w must be on one device")
    coords_cad, dpc, w = (t.contiguous() for t in (coords_cad, dpc, w))
    lib = _build.library("consistency_rank_major.cu")
    segments = rank_major_segments_on(w.device, bsz, v2, k)
    out = torch.empty((bsz, p), dtype=torch.float32, device=w.device)
    # the endpoints packed as (x, y, z, |a|^2) rows, and the segments'
    # partial sums (added in segment order by the kernel's last pass)
    rows = torch.empty((bsz, p, 4), dtype=torch.float32, device=w.device)
    part = (torch.empty((bsz, segments, p), dtype=torch.float32,
                        device=w.device) if segments > 1 else None)
    code = lib.consistency_sum_rank_major_f32(
        coords_cad.data_ptr(), dpc.data_ptr(), w.data_ptr(), out.data_ptr(),
        rows.data_ptr(), None if part is None else part.data_ptr(), bsz, v2,
        k, segments, _build.stream_ptr(w.device))
    _build.check(code, "consistency_sum_rank_major")
    _build.LAUNCHES["consistency_sum_rank_major"] += 1
    return out


def masked_consistency_sum_plain(ca, cb, w):
    """sum_i w_i * | ||ca_i - ca_j|| - ||cb_i - cb_j|| | per pair j, one
    frame at a time, distances from the |x|^2 - 2xy + |y|^2 expansion
    as the JAX package computes them."""
    out = []
    for a, b, wf in zip(ca, cb, w):
        da = torch.sqrt(pairwise_sqdist(a, a))
        db = torch.sqrt(pairwise_sqdist(b, b))
        out.append(wf @ torch.abs(da - db))
    return torch.stack(out)


def masked_consistency_sum(ca, cb, w):
    """ca, cb (B, P, 3) f32 CAD / PC endpoints of P pairs, w (B, P) f32
    row weights (0 for pruned rows). Returns (B, P) f32 sums."""
    if ca.device.type == "cpu":
        return masked_consistency_sum_plain(ca, cb, w)
    if ca.device.type != "cuda":
        raise ValueError(f"unsupported device {ca.device}")
    bsz, p, c = ca.shape
    if c != 3 or cb.shape != ca.shape or w.shape != (bsz, p) or p == 0:
        raise ValueError(f"bad shapes ca{tuple(ca.shape)} cb{tuple(cb.shape)} "
                         f"w{tuple(w.shape)}")
    if any(t.dtype != torch.float32 for t in (ca, cb, w)):
        raise TypeError("ca, cb, w must be float32")
    if not (cb.device == w.device == ca.device):
        raise ValueError("ca, cb, w must be on one device")
    ca, cb, w = (t.contiguous() for t in (ca, cb, w))
    lib = _build.library("masked_consistency_sum.cu")
    segments = consistency_segments_on(w.device, bsz, p)
    out = torch.empty((bsz, p), dtype=torch.float32, device=w.device)
    # each point packed as two float4 rows (ca, w) and (cb, finite flag),
    # and the segments' partial sums (added in segment order by the
    # kernel's last pass)
    rows = torch.empty((bsz, p, 8), dtype=torch.float32, device=w.device)
    part = (torch.empty((bsz, segments, p), dtype=torch.float32,
                        device=w.device) if segments > 1 else None)
    code = lib.masked_consistency_sum_f32(
        ca.data_ptr(), cb.data_ptr(), w.data_ptr(), out.data_ptr(),
        rows.data_ptr(), None if part is None else part.data_ptr(), bsz, p,
        segments, _build.stream_ptr(w.device))
    _build.check(code, "masked_consistency_sum")
    _build.LAUNCHES["masked_consistency_sum"] += 1
    return out
