"""GNC-TLS robust registration, the TEASER++ counterpart (port of
pose6d_tpu/solvers/gnc.py, batched over a leading B).

The reference runs the TEASER++ C++ solver (scripts/test_teaser.py:
362-370: noise_bound 0.05, GNC-TLS rotation, gnc_factor 1.4, max_iter
100, cost_threshold 1e-12). Here: graduated non-convexity over a
truncated-least-squares cost, solved for (R, t) by iteratively
reweighted Kabsch, optionally seeded by a block search over 3-point
hypotheses, with the max-clique stage as iterative degree peeling of
the pairwise-consistency graph (consistency_core). Plain PyTorch: the
JAX functions are plain XLA.

The JAX loop is a while_loop under vmap: a frame that has converged
keeps its state while the others go on. The port keeps a per-frame
`active` mask and reads "any frame active" on the host once per
iteration (Kabsch's eigh synchronises the host every iteration anyway).
"""
from __future__ import annotations

import torch

from ..ops.geometry import pairwise_sqdist
from .kabsch import kabsch_umeyama, transform_residuals, triad_rigid

BIGCOST = 1e30
INIT_BLOCK = 512   # hypotheses drawn and scored together


def consistency_core(src, dst, valid, noise_bound: float = 0.05,
                     rounds: int = 6, degree_frac: float = 0.5,
                     row_block: int = 1024):
    """Mutual pairwise-consistency core (TEASER's max-clique stage as
    degree peeling). src, dst (B, N, 3); valid (B, N). Edge (i, j) iff
    | |src_i - src_j| - |dst_i - dst_j| | <= 2 noise_bound. Each of
    `rounds` rounds counts every surviving vertex's degree in
    (row_block, N) blocks (the (N, N) adjacency is never built) and
    drops vertices below degree_frac of the round's maximum degree,
    unless fewer than 3 would survive. Returns the surviving mask."""
    src = src.float()
    dst = dst.float()
    n = src.shape[1]
    tau = 2.0 * noise_bound

    def degrees(keep):
        kf = keep.float()
        deg = []
        for i0 in range(0, n, row_block):
            rs, rd = src[:, i0:i0 + row_block], dst[:, i0:i0 + row_block]
            da = torch.sqrt(pairwise_sqdist(rs, src))
            db = torch.sqrt(pairwise_sqdist(rd, dst))
            deg.append(((torch.abs(da - db) <= tau).float()
                        * kf[:, None]).sum(-1))
        # self-edges are not counted
        return torch.cat(deg, 1) - kf

    keep = valid.bool()
    for _ in range(rounds):
        deg = degrees(keep)
        max_deg = torch.where(keep, deg, 0.0).amax(-1, keepdim=True)
        keep2 = keep & (deg >= degree_frac * max_deg)
        # never peel to extinction: keep the old mask if < 3 survive
        keep = torch.where(keep2.sum(-1, keepdim=True) >= 3, keep2, keep)
    return keep


def _triad_init(src, dst, valid, eps2, init_hypotheses, init_block,
                generator, uniforms):
    """Best of `init_hypotheses` 3-point triads per frame by inlier count
    (d2 < eps2), scored in blocks of init_block; the overshoot rows of
    the last block never win, ties go to the earlier hypothesis."""
    bsz, n = valid.shape
    dev = src.device
    n_blocks = -(-init_hypotheses // init_block)
    v = valid.float()
    valid_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    n_valid_i = torch.clamp(valid.sum(-1), min=1).to(torch.int32)
    rows = torch.arange(bsz, device=dev)[:, None, None]
    ar = torch.arange(bsz, device=dev)
    R0 = torch.eye(3, device=dev).expand(bsz, 3, 3).clone()
    t0 = torch.zeros((bsz, 3), device=dev)
    best = torch.full((bsz,), -2.0, device=dev)
    for blk in range(n_blocks):
        if uniforms is not None:
            u = uniforms[:, blk].to(device=dev, dtype=torch.float32)
        else:
            u = torch.rand((bsz, init_block, 3), generator=generator,
                           device=dev)
        slots = (u * n_valid_i.float()[:, None, None]).to(torch.int32)
        slots = torch.minimum(slots, (n_valid_i - 1)[:, None, None]).long()
        samples = torch.gather(valid_idx, 1, slots.reshape(bsz, -1))
        samples = samples.reshape(bsz, init_block, 3)
        Rs, ts = triad_rigid(src[rows, samples], dst[rows, samples])
        d2 = torch.zeros((bsz, init_block, n), device=dev)
        for i in range(3):
            pred_i = (Rs[:, :, i, 0, None] * src[:, None, :, 0]
                      + Rs[:, :, i, 1, None] * src[:, None, :, 1]
                      + Rs[:, :, i, 2, None] * src[:, None, :, 2]
                      + ts[:, :, i, None])
            d2 = d2 + (pred_i - dst[:, None, :, i]) ** 2
        counts = ((d2 < eps2) * v[:, None]).sum(-1)
        live = (blk * init_block
                + torch.arange(init_block, device=dev)) < init_hypotheses
        counts = torch.where(live, counts, -1.0)
        b = torch.argmax(counts, dim=-1)
        better = counts[ar, b] > best
        R0 = torch.where(better[:, None, None], Rs[ar, b], R0)
        t0 = torch.where(better[:, None], ts[ar, b], t0)
        best = torch.where(better, counts[ar, b], best)
    return R0, t0


def gnc_tls_pose(src, dst, valid, noise_bound: float = 0.05,
                 cbar2: float = 1.0, gnc_factor: float = 1.4,
                 max_iter: int = 100, cost_threshold: float = 1e-12,
                 init_hypotheses: int = 4096,
                 init_block: int = INIT_BLOCK, core_select: bool = False,
                 generator=None, uniforms=None):
    """Robust (R, t) via GNC-TLS, per frame.

    src, dst (B, N, 3) correspondences, valid (B, N). The JAX function's
    `key` is the triad search: it runs when `generator` (a
    torch.Generator on src's device) or `uniforms` (B, n_blocks,
    init_block, 3) in [0, 1) is given; without either (key=None) the
    least-squares pose seeds the loop. core_select runs
    consistency_core first.

    Returns dict: R (B, 3, 3), t (B, 3), weights (B, N) final TLS
    weights, inliers (B, N) bool (weight > 0.5), n_inliers (B,),
    iterations (B,) GNC iterations run.
    """
    src = src.float()
    dst = dst.float()
    dev = src.device
    if core_select:
        valid = consistency_core(src, dst, valid, noise_bound=noise_bound)
    v = valid.float()
    bsz = v.shape[0]
    eps2 = noise_bound ** 2 * cbar2
    if generator is not None or uniforms is not None:
        R, t = _triad_init(src, dst, valid, eps2, init_hypotheses,
                           init_block, generator, uniforms)
    else:
        R, t = kabsch_umeyama(src, dst, v)
    r2_0 = transform_residuals(R, t, src, dst) ** 2
    r2max = torch.where(valid, r2_0, 0.0).amax(-1)
    eps2_t = torch.tensor(eps2, dtype=torch.float32, device=dev)
    mu = torch.clamp(eps2_t / (2.0 * r2max - eps2_t), min=1e-6)

    def tls_weights(r2, mu):
        # the exact piecewise GNC-TLS weight
        mu = mu[:, None]
        th1 = (mu + 1.0) / mu * eps2_t
        th2 = mu / (mu + 1.0) * eps2_t
        w = torch.sqrt(eps2_t * mu * (mu + 1.0)
                       / torch.clamp(r2, min=1e-12)) - mu
        w = torch.clamp(w, 0.0, 1.0)
        w = torch.where(r2 >= th1, 0.0, w)
        w = torch.where(r2 <= th2, 1.0, w)
        return w * v

    cost = torch.full((bsz,), BIGCOST, device=dev)
    prev = torch.zeros((bsz,), device=dev)
    iters = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    for _ in range(max_iter):
        active = torch.abs(cost - prev) > cost_threshold
        if not bool(active.any()):
            break
        r2 = transform_residuals(R, t, src, dst) ** 2
        w = tls_weights(r2, mu)
        ok = w.sum(-1) >= 3
        R2, t2 = kabsch_umeyama(src, dst, w)
        upd = active & ok
        R = torch.where(upd[:, None, None], R2, R)
        t = torch.where(upd[:, None], t2, t)
        prev = torch.where(active, cost, prev)
        cost = torch.where(active, (w * r2).sum(-1), cost)
        mu = torch.where(active, mu * gnc_factor, mu)
        iters = iters + active.to(torch.int64)
    r2 = transform_residuals(R, t, src, dst) ** 2
    w = tls_weights(r2, mu)
    inliers = (w > 0.5) & valid
    return {"R": R, "t": t, "weights": w, "inliers": inliers,
            "n_inliers": inliers.sum(-1), "iterations": iters}
