"""Weighted Kabsch/Umeyama rigid alignment (port of pose6d_tpu/solvers/kabsch.py).

Horn's quaternion method: the optimal R is the rotation of the
largest-eigenvalue eigenvector of a symmetric 4x4 matrix built from the
cross-covariance. The JAX package finds that eigenvector with 8 unrolled
Jacobi sweeps; kabsch_umeyama takes it from one batched
torch.linalg.eigh (R is invariant to q -> -q, so the two agree), which
on the card waits on the host once for its error check. RANSAC's two
refits and GNC call it. ICP, which updates 30 to 50 times a call, runs
its update as one kernel with the JAX package's Jacobi instead
(ops/kernels/icp.py). triad_rigid is RANSAC's closed-form hypothesis.
All functions take leading batch dimensions.
"""
from __future__ import annotations

import torch

from ..ops.kernels.icp import horn_matrix, rotation_from_quat


def _rotation_from_H_quat(H):
    """Optimal proper rotation maximizing trace(R^T H) via Horn (1987).
    H (..., 3, 3) weighted cross-covariance; returns R (..., 3, 3) with
    R src ~ dst."""
    # largest eigenvalue
    return rotation_from_quat(
        torch.linalg.eigh(horn_matrix(H)).eigenvectors[..., -1])


def kabsch_umeyama(src, dst, weights):
    """Rigid (R, t) minimizing sum_i w_i ||R src_i + t - dst_i||^2.

    src, dst (..., N, 3); weights (..., N) nonnegative. Returns R
    (..., 3, 3), t (..., 3). Degenerate inputs (all-zero weights or rank
    deficiency) return a finite, valid rotation.
    """
    src = src.float()
    dst = dst.float()
    w = weights.float()
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    wn = (w / wsum)[..., None]
    mu_s = (src * wn).sum(-2)
    mu_d = (dst * wn).sum(-2)
    H = (src - mu_s[..., None, :]).transpose(-1, -2) @ (
        (dst - mu_d[..., None, :]) * wn)
    # tiny jitter keeps the eigensolve well-behaved on degenerate inputs
    H = H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device)
    R = _rotation_from_H_quat(H)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def triad_rigid(src3, dst3):
    """Closed-form rigid (R, t) from a minimal 3-point sample.

    Builds an orthonormal frame from each triple (edge, plane normal,
    their cross) and composes R = frame_dst @ frame_src^T. Degenerate
    (near-collinear) triples give a finite but meaningless rotation.
    src3, dst3 (..., 3, 3): rows are points. Returns R (..., 3, 3), t (..., 3).
    """
    a = src3.float()
    b = dst3.float()

    def frame(p):
        e1 = p[..., 1, :] - p[..., 0, :]
        e2 = p[..., 2, :] - p[..., 0, :]
        u1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1,
                                                       keepdim=True), min=1e-12)
        n = torch.linalg.cross(e1, e2, dim=-1)
        u2 = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                             min=1e-12)
        u3 = torch.linalg.cross(u2, u1, dim=-1)
        return torch.stack([u1, u2, u3], dim=-1)     # columns

    R = frame(b) @ frame(a).transpose(-1, -2)
    t = b.mean(-2) - (R @ a.mean(-2)[..., None])[..., 0]
    return R, t


def transform_residuals(R, t, src, dst):
    """Per-point Euclidean residuals ||R src + t - dst||.
    R (..., 3, 3), t (..., 3), src/dst (..., N, 3) -> (..., N)."""
    pred = src @ R.transpose(-1, -2) + t[..., None, :]
    return torch.linalg.vector_norm(pred - dst, dim=-1)
