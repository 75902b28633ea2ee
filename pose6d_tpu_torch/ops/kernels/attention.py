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

# csrc/flash_cross_attention.cu's tiling (the wrapper checks it against
# the built kernel): head counts it takes, keys per staged tile, most
# key tiles one segment walks; a block covers both heads of
# flash_queries_per_block(H) queries
FLASH_HEADS = (1, 2, 4)
FLASH_KEY_TILE, FLASH_MAX_SEGMENT_TILES = 32, 256


def flash_queries_per_block(heads: int) -> int:
    """128 threads, each with 4 (query, head) rows."""
    return 128 * (4 // heads)


def flash_segments(bsz: int, n: int, m: int, heads: int, sms: int,
                   blocks_per_sm: int) -> int:
    """The number of key segments G the forward splits the keys into
    (_build.plan_segments over its query blocks x B and its key tiles):
    at least two blocks on each of `sms` SMs, and no segment walking
    more than FLASH_MAX_SEGMENT_TILES tiles. Segment g takes the key
    tiles _build.segment_tiles(tiles, G, g)."""
    tiles = -(-m // FLASH_KEY_TILE)
    return _build.plan_segments(
        -(-n // flash_queries_per_block(heads)) * bsz, tiles, sms,
        blocks_per_sm, least=-(-tiles // FLASH_MAX_SEGMENT_TILES))


def flash_segments_on(device, bsz: int, n: int, m: int, heads: int) -> int:
    """flash_segments for the built kernel on the card `device` (its
    tiling and blocks per SM asked from the library once)."""
    per_sm = _build.kernel_tiles(
        _build.library("flash_cross_attention.cu").flash_cross_attention_tiles,
        (flash_queries_per_block(heads), FLASH_KEY_TILE,
         FLASH_MAX_SEGMENT_TILES), "flash_cross_attention", heads)
    return flash_segments(bsz, n, m, heads, _build.sm_count(device), per_sm)


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
    # the kernels read whole tokens as 16-byte vectors
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x.contiguous() for x in (q, k, v, kv_valid)))


def _forward_kernel(q, k, v, kv_valid, sm_scale: float, with_lse: bool,
                    segments: int | None = None):
    """Launch the forward on contiguous, checked CUDA inputs; returns
    (out, lse (B, N, H) or None). `segments` overrides the planned key
    split (a check of the unsplit path)."""
    bsz, n, dim, heads = q.shape
    m = k.shape[1]
    if heads not in FLASH_HEADS:
        raise ValueError(f"forward kernel takes {FLASH_HEADS} heads, got "
                         f"{heads}")
    lib = _build.library("flash_cross_attention.cu")
    if segments is None:
        segments = flash_segments_on(q.device, bsz, n, m, heads)
    out = torch.empty_like(q)
    lse = (torch.empty((bsz, n, heads), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    # the key segments' (accumulator, running max and sum) per (query,
    # head), merged in segment order by the kernel's second pass
    part_acc = part_ml = None
    if segments > 1:
        part_acc = torch.empty((bsz, segments, n, dim * heads),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((bsz, segments, n, heads, 2),
                              dtype=torch.float32, device=q.device)
    code = lib.flash_cross_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None,
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), bsz, n, m, dim,
        heads, segments, float(sm_scale), _build.stream_ptr(q.device))
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
