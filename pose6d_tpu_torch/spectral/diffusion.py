"""Spectral heat diffusion (port of pose6d_tpu/spectral/diffusion.py).

x_diffuse = Phi diag(exp(-lambda t)) Phi^T M x: three small matmuls.
"""
from __future__ import annotations

import torch


def to_basis(x, evecs, mass):
    """Phi^T (M x): x (B, V, C), evecs (B, V, K), mass (B, V) -> (B, K, C).
    Padded vertices carry zero mass, so they contribute nothing."""
    return evecs.transpose(-1, -2) @ (x * mass[..., None])


def from_basis(x_spec, evecs):
    """Phi x_spec: (B, K, C) -> (B, V, C)."""
    return evecs @ x_spec


def heat_diffusion(x, time, mass, evals, evecs):
    """Per-channel learned-time heat diffusion in the spectral basis.

    x (B, V, C); time (C,) learned diffusion times (clamped >= 1e-8);
    evals (B, K); evecs (B, V, K); mass (B, V).
    """
    time = torch.clamp(time, min=1e-8)
    x_spec = to_basis(x, evecs, mass)
    coefs = torch.exp(-evals[..., None] * time)
    return from_basis(x_spec * coefs, evecs)
