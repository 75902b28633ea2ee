"""Weighted Kabsch/Umeyama rigid alignment (port of pose6d_tpu/solvers/kabsch.py).

Horn's quaternion method: the optimal R is the rotation of the
largest-eigenvalue eigenvector of a symmetric 4x4 matrix built from the
cross-covariance. The JAX package finds that eigenvector with 8 unrolled
Jacobi sweeps, which eager PyTorch would issue as ~1.5k tiny launches
per call (31 calls per ICP). This port takes it from one batched
torch.linalg.eigh instead; R is invariant to q -> -q, so the two agree.
All functions take leading batch dimensions.
"""
from __future__ import annotations

import torch


def _rotation_from_H_quat(H):
    """Optimal proper rotation maximizing trace(R^T H) via Horn (1987).
    H (..., 3, 3) weighted cross-covariance; returns R (..., 3, 3) with
    R src ~ dst."""
    S = H.unbind(-2)
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = (
        r.unbind(-1) for r in S)
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = torch.linalg.eigh(N).eigenvectors[..., -1]   # largest eigenvalue
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _rotation_from_H_svd(H):
    """The same rotation from H = U S V^T: R = V diag(1, 1, sign det(V
    U^T)) U^T (the JAX package's method="svd")."""
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(V @ Ut))
    S = torch.diag_embed(torch.stack(
        [torch.ones_like(sign), torch.ones_like(sign), sign], -1))
    return V @ S @ Ut


def kabsch_umeyama(src, dst, weights, method: str = "quat"):
    """Rigid (R, t) minimizing sum_i w_i ||R src_i + t - dst_i||^2.

    src, dst (..., N, 3); weights (..., N) nonnegative; method "quat"
    (Horn's quaternion, the default) or "svd". Returns R (..., 3, 3), t
    (..., 3). Degenerate inputs (all-zero weights or rank deficiency)
    return a finite, valid rotation.
    """
    if method not in ("quat", "svd"):
        raise ValueError(f"method must be 'quat' or 'svd': {method!r}")
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
    R = (_rotation_from_H_quat(H) if method == "quat"
         else _rotation_from_H_svd(H))
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
