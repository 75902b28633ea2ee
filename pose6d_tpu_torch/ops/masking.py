"""Static-shape padding / masking helpers (port of pose6d_tpu/ops/masking.py).

Every ragged quantity (CAD vertex count, partial-cloud point count,
correspondence count) is carried as a fixed-size buffer plus a boolean
validity mask.
"""
from __future__ import annotations

import numpy as np
import torch

V_CAD = 5120   # padded CAD vertex budget
V_PC = 2048    # padded partial-cloud budget
K_EIG = 64     # eigenbasis size used for diffusion
N_FMAP = 30    # spectral map size

BIG = 1e9  # sentinel distance for invalid entries


def pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0.0) -> np.ndarray:
    """Pad `x` with `fill` along `axis` up to length `n` (truncates if longer)."""
    x = np.asarray(x)
    cur = x.shape[axis]
    if cur >= n:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n)
        return x[tuple(sl)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, n - cur)
    return np.pad(x, widths, constant_values=fill)


def masked_mean(x, mask, dim: int, eps: float = 1e-12):
    """Mean of `x` along `dim` over entries where `mask` is True."""
    mask = mask.to(x.dtype)
    return (torch.sum(x * mask, dim=dim)
            / (torch.sum(mask.expand_as(x), dim=dim) + eps))


def masked_softmax(logits, mask, dim=-1):
    """Softmax over `dim`, treating mask==False entries as -inf.

    Rows with no valid entry return all zeros (not NaN).
    """
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask, logits, torch.full_like(logits, neg))
    m = torch.amax(masked, dim=dim, keepdim=True)
    e = torch.exp(masked - m) * mask.to(logits.dtype)
    s = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp(s, min=1e-30)
