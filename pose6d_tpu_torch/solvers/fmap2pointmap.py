"""Functional map -> filtered point-to-point pairs (port of
pose6d_tpu/solvers/fmap2pointmap.py, rank-major path).

Top-k spectral CAD candidates per PC point, then three rounds of
pairwise-distance-consistency pruning at (0.3, 0.15, 0.055 with a 0.065
fallback) x the CAD diameter. Pairs are laid out rank-major (pair index
= rank * V2 + pc_point), so the PC side of the (P, P) distance matrix is
the (V2, V2) point table tiled k x k: the consistency sums read that
table (ops/kernels/consistency.py). The PC-major branch and its
masked_consistency_sum kernel are not ported yet.
"""
from __future__ import annotations

import torch

from ..ops.geometry import pairwise_sqdist
from ..ops.kernels.consistency import consistency_sum_rank_major
from ..ops.nn import topk_valid

K_CANDIDATES = 5                    # spectral candidates per PC point
TAUS = (0.3, 0.15, 0.055, 0.065)    # pruning schedule, x diam(CAD)


def _prune_schedule(cmean, valid, diam_cad):
    """Plain rounds for every tau but the last two, then the (tight,
    loose-fallback) final round. valid (B, P); diam_cad (B,)."""
    diam = diam_cad[:, None]
    for tau in TAUS[:-2]:
        valid = valid & (cmean(valid) < tau * diam)
    m = cmean(valid)
    keep_tight = valid & (m < TAUS[-2] * diam)
    keep_loose = valid & (m < TAUS[-1] * diam)
    return torch.where(keep_tight.any(-1, keepdim=True), keep_tight,
                       keep_loose)


def spatial_filtering_fmap2pointmap(C, evecs_x, evecs_y, cad_xyz, pc_xyz,
                                    x_valid, y_valid, diam_cad):
    """C (B, K, K); evecs_x (B, V1, K), evecs_y (B, V2, K); cad_xyz
    (B, V1, 3), pc_xyz (B, V2, 3); x_valid (B, V1), y_valid (B, V2);
    diam_cad (B,).

    Returns pairs (B, 2, V2 * k) int32 with rows [cad_idx, pc_idx] in
    PC-major order (as the JAX package), and valid (B, V2 * k) bool,
    k = K_CANDIDATES.
    """
    k = K_CANDIDATES
    bsz, v2 = y_valid.shape
    diam_cad = torch.as_tensor(diam_cad, dtype=torch.float32,
                               device=cad_xyz.device).expand(bsz)
    emb_x = evecs_x @ C.transpose(-1, -2)
    _, topk = topk_valid(evecs_y, emb_x, x_valid, k=k)      # (B, V2, k)
    cad_idx = topk.reshape(bsz, -1)                          # PC-major
    pc_idx = torch.arange(v2, dtype=torch.int32, device=topk.device)
    pc_idx = pc_idx.repeat_interleave(k).expand(bsz, -1)
    rm_idx = topk.transpose(1, 2).reshape(bsz, -1).long()   # rank-major
    ca_rm = torch.gather(cad_xyz, 1, rm_idx[..., None].expand(-1, -1, 3))
    dpc = torch.sqrt(pairwise_sqdist(pc_xyz, pc_xyz))

    def cmean(v):
        w = v.float()
        denom = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
        return consistency_sum_rank_major(ca_rm, dpc, w, v2) / denom

    valid_rm = _prune_schedule(cmean, y_valid.repeat(1, k), diam_cad)
    valid = valid_rm.reshape(bsz, k, v2).transpose(1, 2).reshape(bsz, -1)
    return torch.stack([cad_idx, pc_idx], dim=1), valid
