"""Functional map -> point-to-point pairs (port of
pose6d_tpu/solvers/fmap2pointmap.py).

naive_fmap2pointmap: each PC point's nearest CAD point in the aligned
spectral embedding (the masked argmin kernel).

spatial_filtering_fmap2pointmap: top-k spectral CAD candidates per PC
point (k = 5 by default), then rounds of pairwise-distance-consistency
pruning on the schedule `taus` (by default 0.3, 0.15, then 0.055 with a
0.065 fallback) x the CAD diameter. Two layouts of the same sums:
- rank-major (default; pair index = rank * V2 + pc_point): the PC side
  of the (P, P) distance matrix is the (V2, V2) point table tiled
  k x k, and the sums read that table (consistency_sum_rank_major);
- PC-major (rank_major=False; pair index = pc_point * k + rank): both
  endpoints explicit (masked_consistency_sum), or, with
  row_subsample > 0, a plain PyTorch screening mean over a strided row
  subset (plain XLA in the JAX package too).
"""
from __future__ import annotations

import torch

from ..ops.geometry import pairwise_sqdist
from ..ops.kernels.consistency import (consistency_sum_rank_major,
                                       masked_consistency_sum)
from ..ops.nn import nearest_valid, topk_valid

K_CANDIDATES = 5                    # default spectral candidates per PC point
TAUS = (0.3, 0.15, 0.055, 0.065)    # default pruning schedule, x diam(CAD)


def naive_fmap2pointmap(C, evecs_x, evecs_y, x_valid, y_valid):
    """C (B, K, K); evecs_x (B, V1, K), evecs_y (B, V2, K); x_valid
    (B, V1), y_valid (B, V2). Returns pairs (B, 2, V2) int32 rows
    [cad_idx, pc_idx] and valid (B, V2)."""
    emb_x = evecs_x @ C.transpose(-1, -2)
    _, p2p = nearest_valid(evecs_y, emb_x, x_valid)
    pc_idx = torch.arange(p2p.shape[1], dtype=torch.int32,
                          device=p2p.device).expand_as(p2p)
    return torch.stack([p2p, pc_idx], dim=1), y_valid


def _consistency_mean(ca, cb, row_valid, row_subsample: int = 0):
    """mean_i |d(ca_i, ca_j) - d(cb_i, cb_j)| over valid rows i, per pair
    j. ca, cb (B, P, 3); row_valid (B, P). row_subsample > 0: the mean
    over a strided row subset, a screening approximation (see the JAX
    function's note), plain PyTorch."""
    p = ca.shape[1]
    if row_subsample and row_subsample < p:
        idx = torch.arange(row_subsample, device=ca.device) * (
            p // row_subsample)
        rw = row_valid[:, idx].float()
        denom = torch.clamp(rw.sum(-1, keepdim=True), min=1.0)
        da = torch.sqrt(pairwise_sqdist(ca[:, idx], ca))
        db = torch.sqrt(pairwise_sqdist(cb[:, idx], cb))
        return (torch.abs(da - db) * rw[..., None]).sum(1) / denom
    w = row_valid.float()
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    return masked_consistency_sum(ca, cb, w) / denom


def _prune_schedule(cmean, valid, taus, diam_cad, means=None):
    """Plain rounds for every tau but the last two, then the (tight,
    loose-fallback) final round. valid (B, P); diam_cad (B,). Appends
    each round's means to `means` when it is a list."""
    if len(taus) < 2:
        raise ValueError(f"taus needs at least the final (tight, loose) "
                         f"pair: {taus}")
    diam = diam_cad[:, None]

    def round_mean(v):
        m = cmean(v)
        if means is not None:
            means.append(m)
        return m

    for tau in taus[:-2]:
        valid = valid & (round_mean(valid) < tau * diam)
    m = round_mean(valid)
    keep_tight = valid & (m < taus[-2] * diam)
    keep_loose = valid & (m < taus[-1] * diam)
    return torch.where(keep_tight.any(-1, keepdim=True), keep_tight,
                       keep_loose)


def spatial_filtering_fmap2pointmap(C, evecs_x, evecs_y, cad_xyz, pc_xyz,
                                    x_valid, y_valid, diam_cad,
                                    k: int = K_CANDIDATES, taus=TAUS,
                                    rank_major: bool = True,
                                    row_subsample: int = 0,
                                    return_means: bool = False):
    """C (B, K, K); evecs_x (B, V1, K), evecs_y (B, V2, K); cad_xyz
    (B, V1, 3), pc_xyz (B, V2, 3); x_valid (B, V1), y_valid (B, V2);
    diam_cad (B,); k spectral candidates per PC point; taus the pruning
    schedule as fractions of diam_cad: a plain round for every entry but
    the last two, which are the (tight, loose-fallback) final round.

    Returns pairs (B, 2, V2 * k) int32 with rows [cad_idx, pc_idx] in
    PC-major order (as the JAX package), and valid (B, V2 * k) bool;
    with return_means, also the list of each pruning round's consistency
    means (B, V2 * k), PC-major (diagnostics).
    """
    if rank_major and row_subsample:
        raise ValueError("row_subsample applies to the PC-major path "
                         "(rank_major=False)")
    taus = tuple(float(t) for t in taus)
    bsz, v2 = y_valid.shape
    diam_cad = torch.as_tensor(diam_cad, dtype=torch.float32,
                               device=cad_xyz.device).expand(bsz)
    emb_x = evecs_x @ C.transpose(-1, -2)
    _, topk = topk_valid(evecs_y, emb_x, x_valid, k=k)      # (B, V2, k)
    cad_idx = topk.reshape(bsz, -1)                          # PC-major
    pc_idx = torch.arange(v2, dtype=torch.int32, device=topk.device)
    pc_idx = pc_idx.repeat_interleave(k).expand(bsz, -1)
    pairs = torch.stack([cad_idx, pc_idx], dim=1)
    means = [] if return_means else None

    def gather(xyz, idx):
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))

    if rank_major:
        ca_rm = gather(cad_xyz, topk.transpose(1, 2).reshape(bsz, -1))
        dpc = torch.sqrt(pairwise_sqdist(pc_xyz, pc_xyz))

        def cmean(v):
            w = v.float()
            denom = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
            return consistency_sum_rank_major(ca_rm, dpc, w, v2) / denom

        def pc_major(x):
            return x.reshape(bsz, k, v2).transpose(1, 2).reshape(bsz, -1)

        valid = pc_major(_prune_schedule(cmean, y_valid.repeat(1, k),
                                         taus, diam_cad, means))
        means = None if means is None else [pc_major(m) for m in means]
    else:
        ca, cb = gather(cad_xyz, cad_idx), gather(pc_xyz, pc_idx)
        valid = _prune_schedule(
            lambda v: _consistency_mean(ca, cb, v, row_subsample),
            y_valid.repeat_interleave(k, dim=1), taus, diam_cad, means)
    if return_means:
        return pairs, valid, means
    return pairs, valid
