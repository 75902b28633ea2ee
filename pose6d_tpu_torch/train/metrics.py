"""Training metric: inlier ratio (port of inlier_ratio,
pose6d_tpu/train/metrics.py:18-25, batched)."""
from __future__ import annotations

import torch


def inlier_ratio(pairs, pairs_valid, cad_xyz, align_pc, threshold):
    """Fraction of valid predicted pairs within `threshold` under the GT
    alignment, per frame. pairs (B, 2, P) [cad_idx, pc_idx]; pairs_valid
    (B, P); cad_xyz (B, V1, 3), align_pc (B, V2, 3); threshold (B,)."""
    def gather(xyz, idx):
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))

    d = torch.linalg.norm(gather(cad_xyz, pairs[:, 0])
                          - gather(align_pc, pairs[:, 1]), dim=-1)
    hit = (d < torch.as_tensor(threshold)[..., None]).float()
    v = pairs_valid.float()
    return (hit * v).sum(-1) / (v.sum(-1) + 1e-12)
