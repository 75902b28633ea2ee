"""Masked cross-attention, forward and backward (kernels:
csrc/flash_cross_attention.cu and csrc/flash_cross_attention_bwd.cu).

Port of pose6d_tpu/ops/pallas/attention.py:30 flash_cross_attention
and of the fused backward that JAX's library flash attention brings
with it. For CUDA tensors the forward and the backward are hand-written
kernels, joined by a torch.autograd.Function: the forward saves the
per-(query, head) log-sum-exp and the backward recomputes the
probabilities from it. The log-sum-exp is asked for only when autograd
will need it (grad mode on and an input that requires grad); serving,
under inference_mode, never computes it. For CPU tensors both run the
plain PyTorch version (the XLA branch of
pose6d_tpu/models/attention.py:108-117, kept in f32: the port rounds
nothing to bf16) and autograd through it.
"""
from __future__ import annotations

import torch

from ..masking import masked_softmax
from . import _build


def flash_cross_attention_plain(q, k, v, kv_valid, sm_scale: float):
    scores = torch.einsum("bndh,bmdh->bhnm", q, k) * sm_scale
    prob = masked_softmax(scores, kv_valid[:, None, None, :], dim=-1)
    return torch.einsum("bhnm,bmdh->bndh", prob, v)


def flash_cross_attention_backward_plain(q, k, v, kv_valid, sm_scale: float,
                                         dout):
    """(dq, dk, dv): autograd through the plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_cross_attention_plain(*leaves, kv_valid, sm_scale)
        return torch.autograd.grad(out, leaves, dout)


def _checked(q, k, v, kv_valid):
    """Validate the kernels' inputs; returns them contiguous."""
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
    return tuple(t.contiguous() for t in (q, k, v, kv_valid))


def _forward_kernel(q, k, v, kv_valid, sm_scale: float, with_lse: bool):
    """Launch the forward on contiguous, checked CUDA inputs; returns
    (out, lse (B, N, H) or None)."""
    bsz, n, dim, heads = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bsz, n, heads), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    lib = _build.library("flash_cross_attention.cu")
    code = lib.flash_cross_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None, bsz, n,
        k.shape[1], dim, heads, float(sm_scale), _build.stream_ptr(q.device))
    _build.check(code, "flash_cross_attention")
    _build.LAUNCHES["flash_cross_attention"] += 1
    return out, lse


def flash_cross_attention_backward(q, k, v, kv_valid, sm_scale: float, out,
                                   lse, dout):
    """(dq, dk, dv) of the attention for the upstream gradient dout
    (B, N, dim, H), given the forward's out and lse (B, N, H). CPU
    tensors take the plain version (out and lse are not needed)."""
    if q.device.type == "cpu":
        return flash_cross_attention_backward_plain(q, k, v, kv_valid,
                                                    sm_scale, dout)
    q, k, v, kv_valid = _checked(q, k, v, kv_valid)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[1], q.shape[3]):
        raise ValueError(f"bad shapes out{tuple(out.shape)} "
                         f"dout{tuple(dout.shape)} lse{tuple(lse.shape)}")
    if any(t.dtype != torch.float32 or t.device != q.device
           for t in (out, lse, dout)):
        raise TypeError("out, lse, dout must be float32 on q's device")
    out, lse, dout = (t.contiguous() for t in (out, lse, dout))
    bsz, n, dim, heads = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    lib = _build.library("flash_cross_attention_bwd.cu")
    code = lib.flash_cross_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bsz, n, k.shape[1],
        dim, heads, float(sm_scale), _build.stream_ptr(q.device))
    _build.check(code, "flash_cross_attention_backward")
    _build.LAUNCHES["flash_cross_attention_backward"] += 1
    return dq, dk, dv


class _FlashCrossAttention(torch.autograd.Function):
    """The two kernels as one differentiable op (CUDA only)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, sm_scale):
        out, lse = _forward_kernel(q, k, v, kv_valid, sm_scale, True)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_cross_attention_backward(
            q, k, v, kv_valid, ctx.sm_scale, out, lse, dout)
        return dq, dk, dv, None, None


def flash_cross_attention(q, k, v, kv_valid, sm_scale: float):
    """q (B, N, dim, H), k/v (B, M, dim, H) in the refiner's (dim, heads)
    split, kv_valid (B, M) bool; returns (B, N, dim, H). A query with no
    valid key gets zeros. Differentiable in q, k, v on both devices."""
    if q.device.type == "cpu":
        return flash_cross_attention_plain(q, k, v, kv_valid, sm_scale)
    q, k, v, kv_valid = _checked(q, k, v, kv_valid)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashCrossAttention.apply(q, k, v, kv_valid, sm_scale)
    return _forward_kernel(q, k, v, kv_valid, sm_scale, False)[0]
