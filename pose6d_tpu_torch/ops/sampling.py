"""Farthest point sampling and kNN (port of pose6d_tpu/ops/sampling.py).

FPS is a chain of n_samples - 1 dependent argmax steps over the running
min-distance field: one out-of-place step driven by ops/loops.run_while
(a Python loop eagerly, the while_loop op under torch.export, as
lax.fori_loop in the JAX package), whose pick indices stay on the
device. Grouped FPS splits the valid points into `groups` strata and
runs their chains as one batched chain of n_samples / groups steps.
"""
from __future__ import annotations

import torch

from .geometry import fma_f32, pairwise_sqdist_fma
from .loops import run_while
from .masking import BIG

def farthest_point_sample(points, valid, n_samples: int):
    """Deterministic farthest-point sampling on padded (B, N, 3) sets.

    Starts from each frame's first valid point, then adds the valid
    point farthest from the picked set (the first index on ties, as
    jnp.argmax). Returns idx (B, n_samples) int64 and sel_valid
    (B, n_samples), False where a frame has fewer valid points than
    n_samples (its indices then repeat the last valid pick).
    """
    bsz, n, _ = points.shape
    dev = points.device
    points = points.float()
    first = torch.argmax(valid.to(torch.uint8), dim=-1)
    idx = torch.cat([first[:, None], torch.zeros(
        (bsz, n_samples - 1), dtype=torch.int64, device=dev)], dim=1)
    min_d = torch.full((bsz, n), BIG, dtype=torch.float32, device=dev)
    neg = torch.full_like(min_d, -BIG)

    def more(i, idx, min_d, last):
        return i < n_samples

    def step(i, idx, min_d, last):
        diff = points - torch.gather(points, 1,
                                     last[:, None, None].expand(-1, 1, 3))
        # the fused multiply-adds of the JAX package's jitted reduction
        # (fma_f32 on operands widened once: the same bits)
        wide = diff.double()
        d = fma_f32(wide[..., 2], wide[..., 2], fma_f32(
            wide[..., 1], wide[..., 1], diff[..., 0] * diff[..., 0]))
        min_d = torch.minimum(min_d, d)
        pick = torch.argmax(torch.where(valid, min_d, neg), dim=-1)
        return (i + 1, idx.index_copy(1, i.reshape(1), pick[:, None]), min_d,
                pick)

    one = torch.ones((), dtype=torch.int64, device=dev)
    _, idx, _, _ = run_while(more, step, (one, idx, min_d, first),
                             steps=n_samples - 1)
    n_valid = valid.sum(-1, keepdim=True)
    sel_valid = torch.arange(n_samples, device=dev)[None] < n_valid
    return idx, sel_valid


def farthest_point_sample_grouped(points, valid, n_samples: int,
                                  groups: int = 8):
    """Stratified FPS with a `groups`-fold shorter dependency chain, on
    padded (B, N, 3) sets, as the JAX package's grouped FPS.

    Each frame's valid points are ranked along their largest extent axis
    (a stable sort of that coordinate, ties to the lower index) and cut
    into `groups` contiguous strata of equal count (stratum g starts at
    rank ceil(g * n_valid / groups)); exact FPS picks n_samples / groups
    points inside each stratum. The strata's chains run as one chain over
    B * groups rows, so the device issues n_samples / groups dependent
    steps in place of n_samples. Requires n_samples % groups == 0 and
    N % groups == 0. Returns idx (B, n_samples) int64 indices into
    `points` (stratum by stratum) and sel_valid (B, n_samples), False
    where a stratum has fewer valid points than its share.
    """
    bsz, n, _ = points.shape
    if n_samples % groups or n % groups:
        raise ValueError(f"grouped FPS needs n_samples ({n_samples}) and N "
                         f"({n}) divisible by groups ({groups})")
    dev = points.device
    points = points.float()
    per_grp = n // groups
    n_valid = torch.clamp(valid.sum(-1, keepdim=True), min=1)    # (B, 1)
    vb = valid[..., None]
    lo = torch.where(vb, points, BIG).amin(1)
    hi = torch.where(vb, points, -BIG).amax(1)
    axis = torch.argmax(hi - lo, dim=-1)                          # (B,)
    coord = torch.gather(points, 2, axis[:, None, None].expand(-1, n, 1))
    key = torch.where(valid, coord[..., 0], BIG)
    order = torch.argsort(key, dim=-1, stable=True)   # valid first, by coord
    rank = torch.argsort(order, dim=-1)               # rank of each point
    g = torch.clamp(rank * groups // n_valid, max=groups - 1)
    start = (g * n_valid + groups - 1) // groups      # ceil(g n_valid / G)
    slot = torch.where(valid, g * per_grp + (rank - start), n)
    # each valid point to its stratum's bucket; unfilled slots hold point
    # 0, marked invalid
    src = torch.zeros((bsz, n + 1), dtype=torch.int64, device=dev)
    src.scatter_(1, slot, torch.arange(n, device=dev).expand(bsz, n))
    occ = torch.zeros((bsz, n + 1), dtype=torch.bool, device=dev)
    occ.scatter_(1, slot, valid)
    src, occ = src[:, :n], occ[:, :n]
    pg = torch.gather(points, 1, src[..., None].expand(-1, -1, 3))
    idx_g, val_g = farthest_point_sample(
        pg.reshape(bsz * groups, per_grp, 3),
        occ.reshape(bsz * groups, per_grp), n_samples // groups)
    # bucket index -> the frame's point index
    idx = torch.gather(src.reshape(bsz * groups, per_grp), 1, idx_g)
    return (idx.reshape(bsz, n_samples),
            val_g.reshape(bsz, n_samples))


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
