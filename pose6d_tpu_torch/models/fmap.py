"""Regularized functional-map solver (port of pose6d_tpu/models/fmap.py).

All n_fmap rows are stacked into one (n_fmap, n_fmap, n_fmap) system per
frame and solved with one batched torch.linalg.solve in f32.
"""
from __future__ import annotations

import torch


def resolvent_mask(evals_x, evals_y, gamma: float = 0.5):
    """Spectral resolvent mask D (B, n_fmap, n_fmap): rows by evals_y,
    columns by evals_x."""
    scale = torch.maximum(evals_x.amax(-1), evals_y.amax(-1))[..., None]
    gx = ((evals_x / scale) ** gamma)[..., None, :]
    gy = ((evals_y / scale) ** gamma)[..., :, None]
    m_re = gy / (gy ** 2 + 1) - gx / (gx ** 2 + 1)
    m_im = 1 / (gy ** 2 + 1) - 1 / (gx ** 2 + 1)
    return m_re ** 2 + m_im ** 2


def solve_fmap(feat_x, feat_y, evals_x, evals_y, evecs_trans_x,
               evecs_trans_y, lambda_: float = 100.0, gamma: float = 0.5):
    """Regularized least-squares functional map C12 (x -> y), batched.

    feat_x (B, V1, C), feat_y (B, V2, C); evals_* (B, n_fmap);
    evecs_trans_* (B, n_fmap, V) = Phi[:, :n_fmap]^T diag(mass).
    Row i of C solves (A A^T + lambda diag(D_i)) c_i = (B A^T)_i.
    """
    A = evecs_trans_x @ feat_x                        # (B, K, C)
    Bm = evecs_trans_y @ feat_y
    D = resolvent_mask(evals_x, evals_y, gamma)       # (B, K, K)
    AAt = A @ A.transpose(-1, -2)
    BAt = Bm @ A.transpose(-1, -2)
    k = A.shape[-2]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    M = AAt[:, None] + lambda_ * D[..., None] * eye   # (B, K, K, K)
    return torch.linalg.solve(M, BAt[..., None])[..., 0]
