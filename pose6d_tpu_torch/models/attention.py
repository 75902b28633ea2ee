"""Cross-attention refinement + overlap head (port of pose6d_tpu/models/attention.py).

The default configuration only: attention_type="normal" and
cross_sampling_ratio=1.0 (the other variants are not ported yet). The
V1 x V2 attention runs through ops/kernels/attention.py: the
hand-written online-softmax kernel on the card (and, when autograd
needs it, the hand-written backward), its plain f32 version on the CPU.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.attention import flash_cross_attention
from ..ops.masking import masked_mean


def masked_instance_norm(x, valid, eps: float = 1e-5):
    """Affine-free InstanceNorm over the point axis per channel, over
    valid rows only. x (B, V, C), valid (B, V)."""
    m = valid[..., None]
    mu = masked_mean(x, m, dim=-2)
    var = masked_mean((x - mu[..., None, :]) ** 2, m, dim=-2)
    return (x - mu[..., None, :]) / torch.sqrt(var[..., None, :] + eps)


class ConvMLP(nn.Module):
    """1x1-conv MLP: Linear + masked InstanceNorm + ReLU between layers."""

    def __init__(self, c_in: int, dims):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"lin_{i}", nn.Linear(c_in, d))
            c_in = d

    def forward(self, x, valid):
        for i in range(self.n):
            x = getattr(self, f"lin_{i}")(x)
            if i + 1 < self.n:
                x = torch.relu(masked_instance_norm(x, valid))
        return x


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.dim = d_model // num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.merge = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, q_valid, kv_valid):
        """query (B, N, d_model), key/value (B, M, d_model) -> (B, N, d_model).

        Channel split is (dim, heads), dim-major: channel c = d * H + h,
        as the checkpoints were trained with.
        """
        b, n, d_model = query.shape
        split = (self.dim, self.num_heads)
        q = self.proj_q(query).reshape(b, n, *split)
        k = self.proj_k(key).reshape(b, key.shape[1], *split)
        v = self.proj_v(value).reshape(b, value.shape[1], *split)
        out = flash_cross_attention(q, k, v, kv_valid, self.dim ** -0.5)
        out = self.merge(out.reshape(b, n, d_model))
        return out * q_valid[..., None]


class AttentionalPropagation(nn.Module):
    def __init__(self, feature_dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, feature_dim)
        self.mlp = ConvMLP(2 * feature_dim, (2 * feature_dim, feature_dim))

    def forward(self, x, source, x_valid, src_valid):
        message = self.attn(x, source, source, x_valid, src_valid)
        return self.mlp(torch.cat([x, message], dim=-1), x_valid)


class OverlapPredictorNet(nn.Module):
    """Siamese sigmoid overlap head on L2-normalized features."""

    def __init__(self, c_in: int, overlap_feat_dim: int = 32):
        super().__init__()
        self.lin0 = nn.Linear(c_in, overlap_feat_dim)
        self.lin1 = nn.Linear(overlap_feat_dim, 1)

    def head(self, f):
        norm = f * torch.rsqrt(torch.sum(f * f, dim=-1, keepdim=True) + 1e-12)
        return torch.sigmoid(self.lin1(torch.relu(self.lin0(norm))))[..., 0]

    def forward(self, feat_x, feat_y, x_valid, y_valid):
        return self.head(feat_x) * x_valid, self.head(feat_y) * y_valid


class CrossAttentionRefinementNet(nn.Module):
    def __init__(self, n_in: int = 32, num_heads: int = 2, gnn_dim: int = 32,
                 n_layers: int = 1, overlap_feat_dim: int = 32):
        super().__init__()
        self.first_lin = nn.Linear(n_in, gnn_dim)
        self.n_layers = n_layers
        for li in range(n_layers):
            self.add_module(f"layer_{li}",
                            AttentionalPropagation(gnn_dim, num_heads))
        self.last_lin = nn.Linear(gnn_dim, n_in)
        self.overlap = OverlapPredictorNet(n_in, overlap_feat_dim)

    def forward(self, feat_x, feat_y, x_valid, y_valid):
        """feat_x (B, V1, n_in), feat_y (B, V2, n_in) -> refined feats +
        overlaps."""
        desc0 = self.first_lin(feat_x)
        desc1 = self.first_lin(feat_y)
        for li in range(self.n_layers):
            layer = getattr(self, f"layer_{li}")
            # shared layer, sequential: desc1's update sees the updated desc0
            desc0 = desc0 + layer(desc0, desc1, x_valid, y_valid)
            desc1 = desc1 + layer(desc1, desc0, y_valid, x_valid)
        ref_x = self.last_lin(desc0) * x_valid[..., None]
        ref_y = self.last_lin(desc1) * y_valid[..., None]
        overlap_x, overlap_y = self.overlap(ref_x, ref_y, x_valid, y_valid)
        return ref_x, ref_y, overlap_x, overlap_y
