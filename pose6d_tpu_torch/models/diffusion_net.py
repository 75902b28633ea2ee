"""DiffusionNet feature extractor (port of pose6d_tpu/models/diffusion_net.py).

first_lin(C_in -> width) -> n_blocks x [learned-time heat diffusion +
MiniMLP + skip] -> last_lin(width -> C_out), spectral diffusion, without
gradient features (the variant with them is not ported yet). Padded
rows are re-zeroed after the first layer and after every block so
nothing leaks through the skip path. Submodule names follow the flax
scopes, so checkpoints map onto them mechanically (models/weights.py).
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


class DiffusionBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.diffusion_time = nn.Parameter(torch.zeros(width))
        self.mlp = MiniMLP(2 * width, (width, width, width))

    def forward(self, x, mass, evals, evecs, valid):
        x_diffuse = heat_diffusion(x, self.diffusion_time, mass, evals, evecs)
        out = self.mlp(torch.cat([x, x_diffuse], dim=-1)) + x
        return out * valid[..., None]


class DiffusionNet(nn.Module):
    def __init__(self, c_in: int = 3, c_out: int = 32, width: int = 64,
                 n_blocks: int = 2):
        super().__init__()
        self.first_lin = nn.Linear(c_in, width)
        self.n_blocks = n_blocks
        for b in range(n_blocks):
            self.add_module(f"block_{b}", DiffusionBlock(width))
        self.last_lin = nn.Linear(width, c_out)

    def forward(self, x, mass, evals, evecs, valid):
        """x (B, V, c_in); mass (B, V), evals (B, K), evecs (B, V, K),
        valid (B, V) bool. Returns (B, V, c_out)."""
        x = self.first_lin(x) * valid[..., None]
        for b in range(self.n_blocks):
            x = getattr(self, f"block_{b}")(x, mass, evals, evecs, valid)
        return self.last_lin(x) * valid[..., None]
