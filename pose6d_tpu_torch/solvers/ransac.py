"""Batched correspondence-RANSAC pose estimation (port of pose6d_tpu/solvers/ransac.py).

Blocks of hypotheses are drawn from each frame's compacted valid table
(3-point triads solved in closed form) and scored together by one kernel
op (ops/kernels/ransac.py, which on the card keeps the residuals in
registers and skips the frames that have exited); a frame stops drawing
once its best hypothesis's inlier ratio eps meets the trial bound
T(eps) = log(1 - confidence) / log(1 - eps^3), or when the budget is
spent. Frames of a batch exit independently: a frame that has met its
bound keeps its best hypothesis while the others go on (as jax.vmap over
lax.while_loop does). The block loop is one out-of-place step driven by
ops/loops.run_while, so torch.export traces it as a while_loop whose
exit is that adaptive one. Two least-squares refits on the inliers
follow.
"""
from __future__ import annotations

import math

import torch

from ..ops.kernels import ransac_inlier_counts
from ..ops.loops import run_while
from ..utils.profiling import count, span, spanned
from .kabsch import kabsch_umeyama, transform_residuals, triad_rigid

CONFIDENCE = 0.999   # success confidence of the early-exit bound
REFIT_ROUNDS = 2


def _required_trials(best, n_valid):
    eps = torch.clamp(best / n_valid, 0.0, 1.0)
    p_good = torch.clamp(eps ** 3, 1e-12, 1.0 - 1e-7)
    return math.log1p(-CONFIDENCE) / torch.log1p(-p_good)


@spanned("ransac")
def ransac_pose(src, dst, valid, threshold, n_hypotheses: int = 131072,
                hyp_block: int = 1024, generator=None, uniforms=None):
    """Robust (R, t) from putative correspondences, per frame.

    src, dst (B, N, 3) CAD- and PC-side coordinates; valid (B, N) bool;
    threshold (B,) or scalar inlier distance; each hypothesis is the
    closed-form triad of 3 drawn pairs. Draws come from `generator` (a
    torch.Generator on src's device) or, if given, from `uniforms`
    (B, n_blocks, hyp_block, 3) in [0, 1), which lets a test hand the
    JAX package the same draws.

    Returns dict: R (B, 3, 3), t (B, 3), inliers (B, N) bool,
    n_inliers (B,), n_trials (B,) trials drawn, ok (B,) bool.
    """
    src = src.float()
    dst = dst.float()
    bsz = valid.shape[0]
    dev = src.device
    hyp_block = min(hyp_block, n_hypotheses)
    n_blocks = -(-n_hypotheses // hyp_block)
    threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                device=dev).expand(bsz)
    thr2 = threshold * threshold
    vmask = valid.float()
    n_valid = torch.clamp(vmask.sum(-1), min=1.0)
    # the pairs with the valid ones compacted to the front, order kept
    # (stable sort): the draws index this prefix, and the scoring kernel
    # skips the tiles of the invalid tail (a count does not depend on the
    # pairs' order)
    valid_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    idx3 = valid_idx[..., None].expand(-1, -1, 3)
    src_c, dst_c = torch.gather(src, 1, idx3), torch.gather(dst, 1, idx3)
    vmask_c = torch.gather(vmask, 1, valid_idx)
    n_valid_i = valid.sum(-1).to(torch.int32)
    max_slot = torch.clamp(n_valid_i - 1, min=0)[:, None, None]
    rows = torch.arange(bsz, device=dev)[:, None, None]

    def run_block(u, active):
        """Best hypothesis of one block per frame; u (B, hyp_block, 3);
        the frames not `active` are not scored."""
        slots = (u * n_valid_i.float()[:, None, None]).to(torch.int32)
        slots = torch.minimum(slots, max_slot).long()
        Rs, ts = triad_rigid(src_c[rows, slots], dst_c[rows, slots])
        counts = ransac_inlier_counts(Rs, ts, src_c, dst_c, vmask_c, thr2,
                                      active)
        b = torch.argmax(counts, dim=-1)
        ar = torch.arange(bsz, device=dev)
        return Rs[ar, b], ts[ar, b], counts[ar, b]

    if uniforms is not None:
        uniforms = uniforms.to(device=dev, dtype=torch.float32)

    def draw(blk):
        if uniforms is not None:
            return uniforms.index_select(1, blk.reshape(1))[:, 0]
        return torch.rand((bsz, hyp_block, 3), generator=generator,
                          device=dev)

    def active_of(best, done):
        return (done < n_blocks) & (
            done * hyp_block < _required_trials(best, n_valid))

    def more(blk, R, t, best, done):
        return (blk < n_blocks) & active_of(best, done).any()

    def step(blk, R, t, best, done):
        count("ransac.frame_blocks", bsz)
        with span("ransac.block"):
            active = active_of(best, done)
            Rb, tb, cb = run_block(draw(blk), active)
            better = active & (cb > best)
            R = torch.where(better[:, None, None], Rb, R)
            t = torch.where(better[:, None], tb, t)
            best = torch.where(active, torch.maximum(best, cb), best)
            return blk + 1, R, t, best, done + active.to(torch.int64)

    _, R, t, _, done = run_while(more, step, (
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.eye(3, device=dev).expand(bsz, 3, 3).clone(),
        torch.zeros((bsz, 3), device=dev), torch.zeros(bsz, device=dev),
        torch.zeros(bsz, dtype=torch.int64, device=dev)))
    count("ransac.live_frame_blocks", done)

    # local refinement: least-squares refit on the inlier set, iterated
    with span("ransac.refit"):
        for _ in range(REFIT_ROUNDS):
            r = transform_residuals(R, t, src, dst)
            w = ((r < threshold[:, None]) & valid).float()
            R2, t2 = kabsch_umeyama(src, dst, w)
            ok = w.sum(-1) >= 3       # keep the pose if the set collapsed
            R = torch.where(ok[:, None, None], R2, R)
            t = torch.where(ok[:, None], t2, t)
    r = transform_residuals(R, t, src, dst)
    inliers = (r < threshold[:, None]) & valid
    n_inl = inliers.sum(-1)
    return {"R": R, "t": t, "inliers": inliers, "n_inliers": n_inl,
            "n_trials": done * hyp_block, "ok": n_inl >= 3}
