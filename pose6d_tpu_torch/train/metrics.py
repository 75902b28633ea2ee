"""Evaluation metrics: inlier ratio, ADD, ADD-S, pose errors (port of
pose6d_tpu/train/metrics.py, batched over a leading B).

The reference's metric vocabulary: IR, the ADD distance and its < 0.1 d
score, the HybridPose per-axis "add score xyz" variant, ADD-S through
nearest-neighbour distances, angular and translation error. ADD-S runs
its nearest-neighbour search through ops/nn.nearest_valid (the masked
argmin kernel on the card), never as a (V, V) distance matrix.
"""
from __future__ import annotations

import math

import torch

from ..ops.masking import BIG, masked_mean
from ..ops.nn import nearest_valid


def _gather_rows(xyz, idx):
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))


def inlier_ratio(pairs, pairs_valid, cad_xyz, align_pc, threshold):
    """Fraction of valid predicted pairs within `threshold` under the GT
    alignment, per frame. pairs (B, 2, P) [cad_idx, pc_idx]; pairs_valid
    (B, P); cad_xyz (B, V1, 3), align_pc (B, V2, 3); threshold (B,)."""
    d = torch.linalg.norm(_gather_rows(cad_xyz, pairs[:, 0])
                          - _gather_rows(align_pc, pairs[:, 1]), dim=-1)
    hit = (d < torch.as_tensor(threshold)[..., None]).float()
    v = pairs_valid.float()
    return (hit * v).sum(-1) / (v.sum(-1) + 1e-12)


def transform(pts, T):
    """pts (..., N, 3) under the rigid transforms T (..., 4, 4)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _mean(x, valid):
    if valid is None:
        return x.mean(-1)
    return masked_mean(x, valid, dim=-1)


def add_distance(T_est, T_gt, pts, valid=None):
    """Mean vertex displacement between the two poses (reference
    test_RANSAC.py:162-173). T (B, 4, 4), pts (B, N, 3), valid (B, N)."""
    d = torch.linalg.norm(transform(pts, T_est) - transform(pts, T_gt),
                          dim=-1)
    return _mean(d, valid)


def _below(e, diameter, percentage):
    return (e < torch.as_tensor(diameter) * percentage).float()


def add_score(T_est, T_gt, pts, diameter, valid=None, percentage=0.1):
    """(ADD distance (B,), its 0/1 score (B,) at percentage * diameter)."""
    e = add_distance(T_est, T_gt, pts, valid)
    return e, _below(e, diameter, percentage)


def add_score_xyz(T_est, T_gt, pts, diameter, valid=None, percentage=0.1):
    """HybridPose per-axis variant (reference test_RANSAC.py:186-201):
    each row of R treated separately, the per-axis mean distances
    scored and averaged."""
    dR = T_gt[..., :3, :3] - T_est[..., :3, :3]
    dt = T_gt[..., :3, 3] - T_est[..., :3, 3]
    per_axis = torch.abs(pts @ dR.transpose(-1, -2) + dt[..., None, :])
    if valid is None:
        means = per_axis.mean(-2)
    else:
        means = masked_mean(per_axis, valid[..., None], dim=-2)
    return _below(means, torch.as_tensor(diameter)[..., None],
                  percentage).mean(-1)


def adds_distance(T_est, T_gt, pts, valid=None):
    """ADD-S: mean nearest-neighbour distance between the transformed
    vertex sets (reference test_RANSAC.py:203-222)."""
    a = transform(pts, T_est).float().contiguous()
    b = transform(pts, T_gt).float().contiguous()
    bv = (torch.ones(b.shape[:-1], dtype=torch.bool, device=b.device)
          if valid is None else valid)
    d2, _ = nearest_valid(a, b, bv)
    return _mean(torch.sqrt(d2), valid)


def adds_score(T_est, T_gt, pts, diameter, valid=None, percentage=0.1):
    e = adds_distance(T_est, T_gt, pts, valid)
    return e, _below(e, diameter, percentage)


def adds_score_xyz(T_est, T_gt, pts, diameter, valid=None, percentage=0.1):
    """Per-axis 1-D nearest-neighbour variant, the semantics of the
    reference's committed 'Add-S Score' values (its KDTree loop runs
    over the three rows of R): each axis scored as a 1-D problem, sort
    and searchsorted (left side), the three 0/1 scores averaged."""
    n = pts.shape[-2]
    scores = []
    for i in range(3):
        a = pts @ T_est[..., i, :3, None] + T_est[..., i, None, 3, None]
        b = pts @ T_gt[..., i, :3, None] + T_gt[..., i, None, 3, None]
        a, b = a[..., 0], b[..., 0]
        if valid is not None:
            b = torch.where(valid, b, torch.full_like(b, BIG))
        bs = torch.sort(b, dim=-1).values
        idx = torch.clamp(torch.searchsorted(bs, a.contiguous()), 1, n - 1)
        d = torch.minimum(torch.abs(a - torch.gather(bs, -1, idx)),
                          torch.abs(a - torch.gather(bs, -1, idx - 1)))
        scores.append(_below(_mean(d, valid), diameter, percentage))
    return torch.stack(scores, -1).mean(-1)


def angular_error_rad(R_gt, R_est):
    """Geodesic rotation error (reference test_RANSAC.py:77-81)."""
    tr = torch.diagonal(R_gt.transpose(-1, -2) @ R_est, dim1=-2,
                        dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def translation_error(t_gt, t_est):
    return torch.linalg.norm(t_gt - t_est, dim=-1)


def rotation_error_logm_deg(R_gt, R_est):
    """|| logm(R_est R_gt^T) / 2 ||_F in degrees (the reference's
    compute_pose_error, test_RANSAC.py:224-238), through the closed form
    ||logm(R)||_F = sqrt(2) theta."""
    theta = angular_error_rad(R_gt, R_est)
    return torch.rad2deg(math.sqrt(2.0) * theta / 2.0)
