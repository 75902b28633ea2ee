"""Pairwise distances and GT correspondence masks (port of parts of
pose6d_tpu/ops/geometry.py)."""
from __future__ import annotations

import torch


def pairwise_sqdist(a, b):
    """Squared Euclidean distances, (..., N, C) x (..., M, C) -> (..., N, M).

    Uses the |a|^2 - 2ab + |b|^2 expansion, clamped at 0, as the JAX
    package does (full f32: TF32 is off, see runtime.configure).
    """
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 - 2.0 * cross + b2.transpose(-1, -2), min=0.0)


def radius_correspondence_mask(cad, cad_valid, pc, pc_valid, radius):
    """Dense boolean GT-correspondence mask (..., V1, V2): valid pairs
    within `radius` (compared as d2 <= radius^2 in f32, as the JAX
    function does)."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=cad.device)
    d2 = pairwise_sqdist(cad, pc)
    ok = cad_valid[..., :, None] & pc_valid[..., None, :]
    return ok & (d2 <= r * r)


def overlap_from_mask(corr_mask):
    """overlap_12 (..., V1), overlap_21 (..., V2) from the dense mask."""
    return corr_mask.any(-1), corr_mask.any(-2)
