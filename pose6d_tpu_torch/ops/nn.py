"""Masked nearest-neighbour queries (port of pose6d_tpu/ops/nn.py).

On a CUDA tensor both run the fused kernel of csrc/masked_cdist.cu; on
a CPU tensor its plain version, which is the JAX package's XLA path.
"""
from __future__ import annotations

from .kernels.cdist import masked_argmin_cdist, masked_topk_cdist


def nearest_valid(a, b, b_valid):
    """(d2_min (B, N), idx (B, N) int32): nearest valid b row per a row."""
    return masked_argmin_cdist(a, b, b_valid)


def topk_valid(a, b, b_valid, k: int):
    """(d2 (B, N, k), idx (B, N, k) int32): k nearest valid b rows per a
    row, ascending, first index on ties."""
    return masked_topk_cdist(a, b, b_valid, k=k)
