"""Spatial-consistency sums (kernels: csrc/consistency_rank_major.cu,
csrc/masked_consistency_sum.cu).

Ports of pose6d_tpu/ops/pallas/consistency.py:80
consistency_sum_rank_major (the PC side read from a (V2, V2) table)
and :136 masked_consistency_sum (both endpoints explicit, PC-major).
Each is a torch.library op (pose6d_tpu_torch::consistency_sum_rank_major,
::masked_consistency_sum): the dispatcher runs the hand-written kernel on
CUDA tensors and the plain PyTorch version beside it on CPU tensors. Both
take endpoints of any width C >= 1, as the TPU functions do: C = 3 (what
every caller passes) on the kernels' 3-D instances, other widths on
their any-width instances.
"""
from __future__ import annotations

import torch

from ..geometry import pairwise_sqdist
from . import _build

# csrc/consistency_rank_major.cu's tiling (the wrapper checks it against
# the built kernel): PC columns per block, PC rows per staged tile, column
# ranks per block at most (any k runs as more chunks of them)
RM_COL_TILE, RM_ROW_TILE, RM_RANKS_PER_BLOCK = 64, 32, 5
# the plain versions build their (P, P) tables in column blocks of at
# most this many entries once P^2 exceeds it (P = 49152 at k = 24 and
# V2 = 2048 would be 9.7 GB a table); below it, one block as before
PLAIN_TABLE_ENTRIES = 2 ** 30


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


def plain_column_blocks(p: int, unit: int) -> list:
    """The column blocks [j0, j1) that a plain version over a (P, P) table
    takes: the whole table up to PLAIN_TABLE_ENTRIES entries, else blocks
    of whole `unit`s holding at most that many."""
    if p * p <= PLAIN_TABLE_ENTRIES:
        return [(0, p)]
    step = max(unit, PLAIN_TABLE_ENTRIES // p // unit * unit)
    return [(j, min(p, j + step)) for j in range(0, p, step)]


def consistency_sum_rank_major_plain(coords_cad, dpc, w, v2: int):
    """sum_i w_i * |d_cad(i, j) - dpc(i mod v2, j mod v2)| per pair j,
    one frame at a time (the (P, P) tables are 420 MB at P = 10240), in
    column blocks of whole ranks above PLAIN_TABLE_ENTRIES entries. Each
    block's table is one buffer updated in place: pairwise_sqdist's
    expansion, (a2 - 2 a.b) + b2 clamped at 0, in its rounding (-2 a.b is
    exact and x - y is (-y) + x), then the square root and |d - dpc| with
    the PC table broadcast over the ranks, not tiled."""
    k = coords_cad.shape[1] // v2
    out = []
    for ca, dp, wf in zip(coords_cad, dpc, w):
        a2 = torch.sum(ca * ca, dim=-1, keepdim=True)
        cols = []
        for j0, j1 in plain_column_blocks(k * v2, v2):
            cb = ca[j0:j1]
            b2 = torch.sum(cb * cb, dim=-1, keepdim=True)
            d = (ca @ cb.transpose(-1, -2)).mul_(-2.0).add_(a2).add_(
                b2.transpose(-1, -2)).clamp_(min=0.0).sqrt_()
            d.view(k, v2, -1, v2).sub_(dp[None, :, None, :]).abs_()
            cols.append(wf @ d)
        out.append(torch.cat(cols))
    return torch.stack(out)


def _rank_major_launch(coords_cad, dpc, w, v2: int):
    """Kernel launch on CUDA tensors (the op's CUDA implementation): the
    3-D instance at C = 3, the any-width one otherwise."""
    bsz, p, c = coords_cad.shape
    if v2 < 1 or p % v2 or c < 1:
        raise ValueError(f"kernel takes (B, k * v2, C >= 1): "
                         f"{tuple(coords_cad.shape)}, v2={v2}")
    k = p // v2
    if k < 1:
        raise ValueError(f"kernel takes k >= 1 ranks: P={p}, v2={v2}")
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
    # the endpoints packed as (x, y, z, |a|^2) rows (at other widths the
    # features zero-padded to whole float4s, then |a|^2 in a float4 of its
    # own), and the segments' partial sums (added in segment order by the
    # kernel's last pass)
    rows = torch.empty((bsz, p, 4 if c == 3 else 4 * (-(-c // 4) + 1)),
                       dtype=torch.float32, device=w.device)
    part = (torch.empty((bsz, segments, p), dtype=torch.float32,
                        device=w.device) if segments > 1 else None)
    ptrs = (coords_cad.data_ptr(), dpc.data_ptr(), w.data_ptr(),
            out.data_ptr(), rows.data_ptr(),
            None if part is None else part.data_ptr(), bsz, v2, k)
    if c == 3:
        code = lib.consistency_sum_rank_major_f32(
            *ptrs, segments, _build.stream_ptr(w.device))
    else:
        code = lib.consistency_sum_rank_major_wide_f32(
            *ptrs, c, segments, _build.stream_ptr(w.device))
    _build.check(code, "consistency_sum_rank_major")
    _build.count_launch("consistency_sum_rank_major",
                        (k,) if c == 3 else (k, f"C{c}"))
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


def _pc_major_launch(ca, cb, w):
    """Kernel launch on CUDA tensors (the op's CUDA implementation): the
    3-D instance at C = 3, the any-width one otherwise."""
    bsz, p, c = ca.shape
    if cb.shape != ca.shape or w.shape != (bsz, p) or p == 0 or c == 0:
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
    # each point packed as two float4 rows (ca, w) and (cb, finite flag)
    # (at other widths ca and cb zero-padded to whole float4s, then (w,
    # flag, 0, 0)), and the segments' partial sums (added in segment
    # order by the kernel's last pass)
    rows = torch.empty((bsz, p, 8 if c == 3 else 4 * (2 * -(-c // 4) + 1)),
                       dtype=torch.float32, device=w.device)
    part = (torch.empty((bsz, segments, p), dtype=torch.float32,
                        device=w.device) if segments > 1 else None)
    ptrs = (ca.data_ptr(), cb.data_ptr(), w.data_ptr(), out.data_ptr(),
            rows.data_ptr(), None if part is None else part.data_ptr(), bsz,
            p)
    if c == 3:
        code = lib.masked_consistency_sum_f32(*ptrs, segments,
                                              _build.stream_ptr(w.device))
    else:
        code = lib.masked_consistency_sum_wide_f32(
            *ptrs, c, segments, _build.stream_ptr(w.device))
    _build.check(code, "masked_consistency_sum")
    _build.count_launch("masked_consistency_sum",
                        None if c == 3 else (f"C{c}",))
    return out


@torch.library.custom_op("pose6d_tpu_torch::consistency_sum_rank_major",
                         mutates_args=(), device_types="cpu")
def _rank_major_op(coords_cad: torch.Tensor, dpc: torch.Tensor,
                   w: torch.Tensor, v2: int) -> torch.Tensor:
    return consistency_sum_rank_major_plain(coords_cad, dpc, w, v2)


_rank_major_op.register_kernel("cuda")(_rank_major_launch)


@_rank_major_op.register_fake
def _(coords_cad, dpc, w, v2):
    return w.new_empty(w.shape)


@torch.library.custom_op("pose6d_tpu_torch::masked_consistency_sum",
                         mutates_args=(), device_types="cpu")
def _pc_major_op(ca: torch.Tensor, cb: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    return masked_consistency_sum_plain(ca, cb, w)


_pc_major_op.register_kernel("cuda")(_pc_major_launch)


@_pc_major_op.register_fake
def _(ca, cb, w):
    return w.new_empty(w.shape)


def consistency_sum_rank_major(coords_cad, dpc, w, v2: int):
    """coords_cad (B, P, C) rank-major pair endpoints (P = k * v2, any
    width C >= 1; every caller passes C = 3), dpc (B, v2, v2) f32 PC
    point-distance table, w (B, P) f32 row weights. Returns (B, P) f32
    sums, at any k."""
    return _rank_major_op(coords_cad, dpc, w, v2)


def masked_consistency_sum(ca, cb, w):
    """ca, cb (B, P, C) f32 CAD / PC endpoints of P pairs (any width C
    >= 1; every caller passes C = 3), w (B, P) f32 row weights (0 for
    pruned rows). Returns (B, P) f32 sums."""
    return _pc_major_op(ca, cb, w)
