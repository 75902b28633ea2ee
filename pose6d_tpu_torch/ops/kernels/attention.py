"""Masked cross-attention forward (kernel: csrc/flash_cross_attention.cu).

Port of pose6d_tpu/ops/pallas/attention.py:30 flash_cross_attention.
For a CUDA tensor the wrapper launches the hand-written online-softmax
kernel; for a CPU tensor it runs the plain PyTorch version beside it
(the XLA branch of pose6d_tpu/models/attention.py:108-117, kept in f32:
the port rounds nothing to bf16).
"""
from __future__ import annotations

import torch

from ..masking import masked_softmax
from . import _build


def flash_cross_attention_plain(q, k, v, kv_valid, sm_scale: float):
    scores = torch.einsum("bndh,bmdh->bhnm", q, k) * sm_scale
    prob = masked_softmax(scores, kv_valid[:, None, None, :], dim=-1)
    return torch.einsum("bhnm,bmdh->bndh", prob, v)


def flash_cross_attention(q, k, v, kv_valid, sm_scale: float):
    """q (B, N, dim, H), k/v (B, M, dim, H) in the refiner's (dim, heads)
    split, kv_valid (B, M) bool; returns (B, N, dim, H). A query with no
    valid key gets zeros."""
    if q.device.type == "cpu":
        return flash_cross_attention_plain(q, k, v, kv_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bsz, n, dim, heads = q.shape
    m = k.shape[1]
    if k.shape != (bsz, m, dim, heads) or v.shape != k.shape \
            or kv_valid.shape != (bsz, m):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} kv_valid{tuple(kv_valid.shape)}")
    if dim != 16 or n == 0 or m == 0:
        raise ValueError(f"kernel takes head dim 16, got {dim}")
    if any(t.dtype != torch.float32 for t in (q, k, v)) \
            or kv_valid.dtype != torch.bool:
        raise TypeError("q, k, v must be float32 and kv_valid bool")
    if not (k.device == v.device == kv_valid.device == q.device):
        raise ValueError("q, k, v, kv_valid must be on one device")
    q, k, v, kv_valid = (t.contiguous() for t in (q, k, v, kv_valid))
    out = torch.empty_like(q)
    lib = _build.library("flash_cross_attention.cu")
    code = lib.flash_cross_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), bsz, n, m, dim, heads, float(sm_scale),
        _build.stream_ptr(q.device))
    _build.check(code, "flash_cross_attention")
    _build.LAUNCHES["flash_cross_attention"] += 1
    return out
