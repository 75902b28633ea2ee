"""DiffusionNet feature extractor (port of pose6d_tpu/models/diffusion_net.py).

first_lin(C_in -> width) -> n_blocks x [learned-time heat diffusion
(+ tangent-gradient features) + MiniMLP + skip] -> last_lin(width ->
C_out), spectral diffusion. Padded rows are re-zeroed after the first
layer and after every block so nothing leaks through the skip path.
Submodule names follow the flax scopes, so checkpoints map onto them
mechanically (models/weights.py).

The gradient-feature variant (with_gradient_features) reads the shape's
tangent-gradient operators in gather form: grad_idx (B, V, Kn) int,
grad_cx / grad_cy (B, V, Kn) f32, the padded rows of the sparse (V, V)
gradX / gradY (spectral/operators.gradients_to_gather). Each directional
derivative is one gather and a weighted sum. The gather's backward
(torch.gather's) scatter-adds into the features' gradient with atomics
on the card, in no fixed order: the card's gradients of this variant
vary from run to run in the last bits, and are held to a tolerance.
"""
from __future__ import annotations

import torch
from torch import nn

from ..spectral.diffusion import heat_diffusion


class MiniMLP(nn.Module):
    """Linear stack with ReLU between layers (none after the last)."""

    def __init__(self, c_in: int, dims):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"layer_{i:03d}", nn.Linear(c_in, d))
            c_in = d

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer_{i:03d}")(x)
            if i + 1 < self.n:
                x = torch.relu(x)
        return x


def apply_gather_gradient(coef, idx, x):
    """One directional derivative: row i of the sparse operator holds
    coef[b, i, :] at columns idx[b, i, :]. coef (B, V, Kn), idx (B, V,
    Kn), x (B, V, C) -> (B, V, C)."""
    bsz, v, kn = idx.shape
    rows = torch.gather(x, 1, idx.reshape(bsz, v * kn, 1).long().expand(
        -1, -1, x.shape[-1])).reshape(bsz, v, kn, x.shape[-1])
    return torch.einsum("bvk,bvkc->bvc", coef, rows)


class SpatialGradientFeatures(nn.Module):
    """Tangent-gradient inner-product features (DiffusionNet, Sharp et
    al. 2022): (d/dX, d/dY) as a complex field z, a learned per-channel
    linear map A (complex with with_gradient_rotations), tanh(Re(conj(z)
    A z)). The maps are bias-free."""

    def __init__(self, width: int, with_gradient_rotations: bool = True):
        super().__init__()
        self.with_gradient_rotations = with_gradient_rotations
        if with_gradient_rotations:
            self.A_re = nn.Linear(width, width, bias=False)
            self.A_im = nn.Linear(width, width, bias=False)
        else:
            self.A = nn.Linear(width, width, bias=False)

    def forward(self, gx, gy):
        if self.with_gradient_rotations:
            zr = self.A_re(gx) - self.A_im(gy)
            zi = self.A_im(gx) + self.A_re(gy)
        else:
            zr, zi = self.A(gx), self.A(gy)
        return torch.tanh(gx * zr + gy * zi)


class DiffusionBlock(nn.Module):
    def __init__(self, width: int, with_gradient_features: bool = False,
                 with_gradient_rotations: bool = True):
        super().__init__()
        self.with_gradient_features = with_gradient_features
        self.diffusion_time = nn.Parameter(torch.zeros(width))
        if with_gradient_features:
            self.gradient_features = SpatialGradientFeatures(
                width, with_gradient_rotations)
        n_cat = 3 if with_gradient_features else 2
        self.mlp = MiniMLP(n_cat * width, (width, width, width))

    def forward(self, x, mass, evals, evecs, valid, grad=None):
        x_diffuse = heat_diffusion(x, self.diffusion_time, mass, evals, evecs)
        if self.with_gradient_features:
            idx, cx, cy = grad
            gx = apply_gather_gradient(cx, idx, x_diffuse)
            gy = apply_gather_gradient(cy, idx, x_diffuse)
            gfeat = self.gradient_features(gx, gy)
            combined = torch.cat([x, x_diffuse, gfeat], dim=-1)
        else:
            combined = torch.cat([x, x_diffuse], dim=-1)
        out = self.mlp(combined) + x
        return out * valid[..., None]


class DiffusionNet(nn.Module):
    def __init__(self, c_in: int = 3, c_out: int = 32, width: int = 64,
                 n_blocks: int = 2, with_gradient_features: bool = False,
                 with_gradient_rotations: bool = True):
        super().__init__()
        self.with_gradient_features = with_gradient_features
        self.first_lin = nn.Linear(c_in, width)
        self.n_blocks = n_blocks
        for b in range(n_blocks):
            self.add_module(f"block_{b}", DiffusionBlock(
                width, with_gradient_features, with_gradient_rotations))
        self.last_lin = nn.Linear(width, c_out)

    def forward(self, x, mass, evals, evecs, valid, grad=None):
        """x (B, V, c_in); mass (B, V), evals (B, K), evecs (B, V, K),
        valid (B, V) bool; grad (idx, cx, cy) gather-form tangent-gradient
        operators, each (B, V, Kn), required iff with_gradient_features.
        Returns (B, V, c_out)."""
        if self.with_gradient_features and grad is None:
            raise ValueError("with_gradient_features=True requires grad "
                             "operators (idx, cx, cy)")
        x = self.first_lin(x) * valid[..., None]
        for b in range(self.n_blocks):
            x = getattr(self, f"block_{b}")(x, mass, evals, evecs, valid,
                                            grad)
        return self.last_lin(x) * valid[..., None]
