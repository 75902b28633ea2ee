"""Pairwise distances (port of pose6d_tpu/ops/geometry.py:pairwise_sqdist)."""
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
