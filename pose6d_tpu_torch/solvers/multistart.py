"""Symmetry-flip disambiguation (port of pose6d_tpu/solvers/multistart.py).

A functional map cannot tell a shape from its near-symmetric images, so
the pipeline can land on a flipped pose. These stages refine a bank of
flip hypotheses (the base pose composed with model-frame rotations about
the CAD centroid) by a short ICP each and keep the best-explaining one:
disambiguate_pose_depth scores every refined hypothesis against the
observed depth image (solvers/verify_pose.py), keeps the base unless an
alternative is clearly better and refines the winner. The H hypotheses
of B frames run as one ICP batch of B * H.
so3_bank is the coarse rotation bank of rotation TTA.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profiling import count, counting, span, spanned
from .icp import icp_cloud_to_model
from .verify_pose import depth_consistency_score


def so3_bank(n: int) -> np.ndarray:
    """First n (at most 10) of a fixed coarse SO(3) bank, (n, 3, 3) f32
    numpy: identity, 180 deg about x, y, z, then +-90 deg about z, y, x."""
    def aa(ax, ang):
        x, y, z = ax
        K = np.array([[0., -z, y], [z, 0., -x], [-y, x, 0.]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    mats = [np.eye(3)]
    for ax in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        mats.append(aa(ax, np.pi))
    for ax in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
        mats.append(aa(ax, np.pi / 2))
        mats.append(aa(ax, -np.pi / 2))
    return np.stack(mats[:n]).astype(np.float32)


def _axis_angle(axis, angle: float):
    """Rodrigues rotations (..., 3, 3) about axes (..., 3)."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


def flip_hypotheses(cad_xyz, cad_valid, R0, t0, rots=None):
    """Pose bank (Rs (B, H, 3, 3), ts (B, H, 3)) about each CAD centroid:
    x_cam = R0 (Rh (x - mu) + mu) + t0.

    rots (H, 3, 3) or (B, H, 3, 3), optional: model-frame rotations
    (ops/symmetry.disambiguation_bank). Without it, the generic bank of
    H = 6: identity, 180 deg about each principal axis of the CAD, and
    +-90 deg about the dominant one."""
    v = cad_valid.to(cad_xyz.dtype)[..., None]
    mu = (cad_xyz * v).sum(-2) / torch.clamp(v.sum(-2), min=1.0)
    if rots is None:
        centered = (cad_xyz - mu[:, None]) * v
        cov = centered.transpose(-1, -2) @ centered
        _, axes = torch.linalg.eigh(cov)    # columns ascending
        rots = torch.stack(
            [torch.eye(3, dtype=cad_xyz.dtype, device=cad_xyz.device
                       ).expand(cov.shape)]
            + [_axis_angle(axes[..., k], math.pi) for k in range(3)]
            + [_axis_angle(axes[..., 2], a) for a in (math.pi / 2,
                                                      -math.pi / 2)], 1)
    else:
        rots = torch.as_tensor(rots, dtype=cad_xyz.dtype,
                               device=cad_xyz.device)
        rots = rots.expand(cad_xyz.shape[0], *rots.shape[-3:])
    Rs = R0[:, None] @ rots
    ts = (t0[:, None] + (R0 @ mu[..., None])[..., 0][:, None]
          - (Rs @ mu[:, None, :, None])[..., 0])
    return Rs, ts


def _per_hyp(x, n_hyp: int):
    return x.repeat_interleave(n_hyp, dim=0)


def _live_bank_rows(sym_rots, bsz: int, n_hyp: int, device):
    """Bank rows that do distinct work: every row but the identity pads
    after row 0 (disambiguation_bank pads with the identity); all of the
    generic bank's."""
    if sym_rots is None:
        return torch.tensor(bsz * n_hyp, device=device)
    rots = torch.as_tensor(sym_rots, device=device).expand(bsz, n_hyp, 3, 3)
    eye = torch.eye(3, dtype=rots.dtype, device=device)
    return bsz * n_hyp - (rots[:, 1:] == eye).flatten(2).all(-1).sum()


@spanned("flip")
def disambiguate_pose_depth(cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0,
                            diam, K, observed_z, mask, icp_iters: int = 15,
                            stride: int = 4, margin: float = 0.25,
                            bank_iters: int = 5, icp_coarse_stride: int = 4,
                            sym_rots=None):
    """Flip disambiguation ranked by depth-image consistency, batched.

    cad_xyz (B, V1, 3), pc_xyz (B, V2, 3) with valid masks; R0 (B, 3, 3),
    t0 (B, 3); diam (B,); K (B, 3, 3); observed_z (B, H, W) in the CAD's
    units (cm), 0 where invalid; mask (B, H, W); sym_rots as
    flip_hypotheses' rots. The bank runs bank_iters ICP iterations
    (coarse stride icp_coarse_stride, one at full resolution); hypotheses
    1 and up are handicapped by (1 + margin); the first minimum wins and
    gets icp_iters - bank_iters more iterations (five at full resolution).
    Returns dict R (B, 3, 3), t (B, 3), score (B,), hypothesis (B,),
    all_scores (B, H), rmse (B,): the full-resolution ICP rmse of the
    returned pose (the winner's refine, or its bank ICP where there is
    no refine).
    """
    bsz = cad_xyz.shape[0]
    Rs, ts = flip_hypotheses(cad_xyz, cad_valid, R0, t0, rots=sym_rots)
    n_hyp = Rs.shape[1]
    bank_iters = min(bank_iters, icp_iters)
    diam = torch.as_tensor(diam, dtype=torch.float32,
                           device=cad_xyz.device).expand(bsz)

    def refine(cx, cv, px, pv, R, t, d, iters, fine_iters):
        icp = icp_cloud_to_model(cx, cv, px, pv, R, t,
                                 max_corr_dist=0.2 * d, max_iter=iters,
                                 coarse_stride=icp_coarse_stride,
                                 fine_iters=fine_iters)
        return icp["R"], icp["t"], icp["rmse"]

    def per_hyp(x):
        return _per_hyp(x, n_hyp)

    with span("flip.bank"):
        Rr, tr, rmse = refine(per_hyp(cad_xyz), per_hyp(cad_valid),
                              per_hyp(pc_xyz), per_hyp(pc_valid),
                              Rs.reshape(-1, 3, 3), ts.reshape(-1, 3),
                              per_hyp(diam), bank_iters, 1)
    Rr, tr = Rr.reshape(bsz, n_hyp, 3, 3), tr.reshape(bsz, n_hyp, 3)
    with span("flip.score"):
        scores = depth_consistency_score(
            cad_xyz[:, None], cad_valid[:, None], Rr, tr, K[:, None],
            observed_z[:, None], mask[:, None], diam[:, None], stride=stride)
    # hysteresis: the base hypothesis stays unless another is clearly
    # better (near-ties are rendering noise, not evidence)
    handicap = torch.full((n_hyp,), 1.0 + margin, device=scores.device)
    handicap[0] = 1.0
    best = torch.argmin(scores * handicap, dim=-1)
    ar = torch.arange(bsz, device=cad_xyz.device)
    R_w, t_w = Rr[ar, best], tr[ar, best]
    if counting():
        count("flip.frames", bsz)
        count("flip.bank_rows", bsz * n_hyp)
        count("flip.changed", (best != 0).sum())
        count("flip.live_bank_rows",
              _live_bank_rows(sym_rots, bsz, n_hyp, cad_xyz.device))
    if icp_iters > bank_iters:
        with span("flip.refine"):
            R_w, t_w, rmse = refine(cad_xyz, cad_valid, pc_xyz, pc_valid,
                                    R_w, t_w, diam, icp_iters - bank_iters, 5)
    else:
        rmse = rmse.reshape(bsz, n_hyp)[ar, best]
    return {"R": R_w, "t": t_w, "score": scores[ar, best],
            "hypothesis": best, "all_scores": scores, "rmse": rmse}
