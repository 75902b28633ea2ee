"""Farthest point sampling and kNN (port of pose6d_tpu/ops/sampling.py).

FPS is a chain of n_samples - 1 dependent argmax steps over the running
min-distance field; here a Python loop whose pick index stays on the
device, so the chain issues its launches without a host sync.
"""
from __future__ import annotations

import torch

from .geometry import fma_f32, pairwise_sqdist_fma
from .masking import BIG

GROUPED_FPS = ("grouped FPS (fps_groups > 1) is not ported yet: "
               "ROADMAP.md, modules still to port, item 7 (online-mode "
               "preprocessing)")


def farthest_point_sample(points, valid, n_samples: int, groups: int = 1):
    """Deterministic farthest-point sampling on padded (B, N, 3) sets.

    Starts from each frame's first valid point, then adds the valid
    point farthest from the picked set (the first index on ties, as
    jnp.argmax). Returns idx (B, n_samples) int64 and sel_valid
    (B, n_samples), False where a frame has fewer valid points than
    n_samples (its indices then repeat the last valid pick).
    """
    if groups > 1:
        raise NotImplementedError(GROUPED_FPS)
    bsz, n, _ = points.shape
    dev = points.device
    points = points.float()
    idx = torch.zeros((bsz, n_samples), dtype=torch.int64, device=dev)
    idx[:, 0] = torch.argmax(valid.to(torch.uint8), dim=-1)
    min_d = torch.full((bsz, n), BIG, dtype=torch.float32, device=dev)
    neg = torch.full_like(min_d, -BIG)
    for i in range(1, n_samples):
        last = torch.gather(points, 1, idx[:, i - 1, None, None].expand(
            -1, 1, 3))
        # the fused multiply-adds of the JAX package's jitted reduction
        d0, d1, d2 = (points - last).unbind(-1)
        d = fma_f32(d2, d2, fma_f32(d1, d1, d0 * d0))
        torch.minimum(min_d, d, out=min_d)
        idx[:, i] = torch.argmax(torch.where(valid, min_d, neg), dim=-1)
    n_valid = valid.sum(-1, keepdim=True)
    sel_valid = torch.arange(n_samples, device=dev)[None] < n_valid
    return idx, sel_valid


def knn(query, query_valid, ref, ref_valid, k: int):
    """k nearest valid ref points per query point, batched.

    query (B, Q, 3), ref (B, R, 3). Returns (dists (B, Q, k) distances,
    idx (B, Q, k) int64), nearest first; invalid refs and queries carry
    BIG squared distances."""
    d2 = pairwise_sqdist_fma(query, ref)
    d2 = torch.where(ref_valid[:, None, :], d2, BIG)
    d2 = torch.where(query_valid[:, :, None], d2, BIG)
    # a stable sort: ties (the expansion clamps near neighbours to 0) go
    # to the lower index, as lax.top_k breaks them
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(d2[..., :k], min=0.0)), idx[..., :k]
