"""Batched correspondence-RANSAC pose estimation (port of pose6d_tpu/solvers/ransac.py).

Blocks of hypotheses are drawn from each frame's compacted valid table
(3-point triads solved in closed form by default; any other sample size
by a weighted Kabsch solve) and scored together; a frame stops drawing
once its best hypothesis's inlier ratio eps meets the trial bound
T(eps) = log(1 - confidence) / log(1 - eps^s), s the sample size, or
when the budget is spent. Frames of a batch exit independently: a frame that has met its
bound keeps its best hypothesis while the others go on (as jax.vmap over
lax.while_loop does). Two least-squares refits on the inliers follow.
"""
from __future__ import annotations

import math

import torch

from .kabsch import kabsch_umeyama, transform_residuals, triad_rigid

CONFIDENCE = 0.999   # success confidence of the early-exit bound
REFIT_ROUNDS = 2


def _required_trials(best, n_valid, sample_size: int):
    eps = torch.clamp(best / n_valid, 0.0, 1.0)
    p_good = torch.clamp(eps ** sample_size, 1e-12, 1.0 - 1e-7)
    return math.log1p(-CONFIDENCE) / torch.log1p(-p_good)


def ransac_pose(src, dst, valid, threshold, n_hypotheses: int = 131072,
                hyp_block: int = 1024, generator=None, uniforms=None,
                sample_size: int = 3):
    """Robust (R, t) from putative correspondences, per frame.

    src, dst (B, N, 3) CAD- and PC-side coordinates; valid (B, N) bool;
    threshold (B,) or scalar inlier distance; sample_size points per
    hypothesis (3: the closed-form triad; any other: kabsch_umeyama).
    Draws come from `generator` (a torch.Generator on src's device) or,
    if given, from `uniforms` (B, n_blocks, hyp_block, sample_size) in
    [0, 1), which lets a test hand the JAX package the same draws.

    Returns dict: R (B, 3, 3), t (B, 3), inliers (B, N) bool,
    n_inliers (B,), n_trials (B,) trials drawn, ok (B,) bool.
    """
    src = src.float()
    dst = dst.float()
    bsz, n = valid.shape
    dev = src.device
    hyp_block = min(hyp_block, n_hypotheses)
    n_blocks = -(-n_hypotheses // hyp_block)
    threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                device=dev).expand(bsz)
    thr2 = (threshold * threshold)[:, None, None]
    vmask = valid.float()
    n_valid = torch.clamp(vmask.sum(-1), min=1.0)
    # valid indices compacted to the front, order kept (stable sort)
    valid_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    n_valid_i = valid.sum(-1).to(torch.int32)
    max_slot = torch.clamp(n_valid_i - 1, min=0)[:, None, None]
    rows = torch.arange(bsz, device=dev)[:, None, None]

    def run_block(u):
        """Best hypothesis of one block per frame; u (B, hyp_block,
        sample_size)."""
        slots = (u * n_valid_i.float()[:, None, None]).to(torch.int32)
        slots = torch.minimum(slots, max_slot).long()
        samples = torch.gather(valid_idx, 1, slots.reshape(bsz, -1))
        samples = samples.reshape(bsz, hyp_block, sample_size)
        if sample_size == 3:
            Rs, ts = triad_rigid(src[rows, samples], dst[rows, samples])
        else:
            Rs, ts = kabsch_umeyama(src[rows, samples], dst[rows, samples],
                                    torch.ones(samples.shape, device=dev))
        # residual planes with the 3-wide contraction unrolled
        d2 = torch.zeros((bsz, hyp_block, n), dtype=torch.float32,
                         device=dev)
        for i in range(3):
            pred_i = (Rs[:, :, i, 0, None] * src[:, None, :, 0]
                      + Rs[:, :, i, 1, None] * src[:, None, :, 1]
                      + Rs[:, :, i, 2, None] * src[:, None, :, 2]
                      + ts[:, :, i, None])
            d2 = d2 + (pred_i - dst[:, None, :, i]) ** 2
        counts = ((d2 < thr2) * vmask[:, None]).sum(-1)
        b = torch.argmax(counts, dim=-1)
        ar = torch.arange(bsz, device=dev)
        return Rs[ar, b], ts[ar, b], counts[ar, b]

    R = torch.eye(3, device=dev).expand(bsz, 3, 3).clone()
    t = torch.zeros((bsz, 3), device=dev)
    best = torch.zeros(bsz, device=dev)
    done = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for blk in range(n_blocks):
        active = (done < n_blocks) & (
            done * hyp_block < _required_trials(best, n_valid,
                                                sample_size))
        if not bool(active.any()):
            break
        if uniforms is not None:
            u = uniforms[:, blk].to(device=dev, dtype=torch.float32)
        else:
            u = torch.rand((bsz, hyp_block, sample_size),
                           generator=generator, device=dev)
        Rb, tb, cb = run_block(u)
        better = active & (cb > best)
        R = torch.where(better[:, None, None], Rb, R)
        t = torch.where(better[:, None], tb, t)
        best = torch.where(active, torch.maximum(best, cb), best)
        done = done + active.to(torch.int64)

    # local refinement: least-squares refit on the inlier set, iterated
    for _ in range(REFIT_ROUNDS):
        r = transform_residuals(R, t, src, dst)
        w = ((r < threshold[:, None]) & valid).float()
        R2, t2 = kabsch_umeyama(src, dst, w)
        ok = w.sum(-1) >= 3           # keep the pose if the set collapsed
        R = torch.where(ok[:, None, None], R2, R)
        t = torch.where(ok[:, None], t2, t)
    r = transform_residuals(R, t, src, dst)
    inliers = (r < threshold[:, None]) & valid
    n_inl = inliers.sum(-1)
    return {"R": R, "t": t, "inliers": inliers, "n_inliers": n_inl,
            "n_trials": done * hyp_block, "ok": n_inl >= 3}
