"""Masked cross-attention, forward and backward (kernels:
csrc/flash_cross_attention.cu and csrc/flash_cross_attention_bwd.cu, the
backward's products on the tensor cores in 3xTF32).

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

Head dims: 16 (every configuration's attention_type="normal" refiner,
gnn_dim / heads) and 32 (attention_type="double", (gnn_dim +
overlap_feat_dim) / heads at both widths), each with 1, 2 or 4 heads.
The kernels' instances hold at most 32 floats a token (16 x 1, 16 x 2,
32 x 1): for dim x heads > 32 the wrappers lay each head out as a frame
of its own, (B, N, dim, H) -> (B H, N, dim, 1), and back (a copy of each
input and output), so a thread keeps as many q and accumulator floats
as at the default 16 x 2.
"""
from __future__ import annotations

import torch

from ..masking import masked_softmax
from . import _build

# csrc/flash_cross_attention.cu's tiling (the wrapper checks it against
# the built kernel): head dims and head counts the wrappers take, floats
# a token of a kernel instance holds at most (wider tokens are folded
# into one-head frames), keys per staged tile, most key tiles one segment
# walks; a block covers every head of flash_queries_per_block(H, dim)
# queries
FLASH_DIMS = (16, 32)
FLASH_HEADS = (1, 2, 4)
FLASH_MAX_TOKEN = 32
FLASH_KEY_TILE, FLASH_MAX_SEGMENT_TILES = 32, 256


def kernel_instance(bsz: int, dim: int, heads: int) -> tuple:
    """(frames, heads) of the kernel launch that serves a (bsz, ., dim,
    heads) call: the heads folded into frames when dim x heads exceeds
    FLASH_MAX_TOKEN."""
    if dim * heads > FLASH_MAX_TOKEN:
        return bsz * heads, 1
    return bsz, heads


def flash_queries_per_block(heads: int, dim: int = 16) -> int:
    """128 threads, each with 64 // dim (query, head) rows."""
    return 128 * (64 // (dim * heads))


def flash_segments(bsz: int, n: int, m: int, heads: int, sms: int,
                   blocks_per_sm: int, dim: int = 16) -> int:
    """The number of key segments G the forward splits the keys into
    (_build.plan_segments over its query blocks x B and its key tiles):
    at least two blocks on each of `sms` SMs, and no segment walking
    more than FLASH_MAX_SEGMENT_TILES tiles. Segment g takes the key
    tiles _build.segment_tiles(tiles, G, g)."""
    tiles = -(-m // FLASH_KEY_TILE)
    return _build.plan_segments(
        -(-n // flash_queries_per_block(heads, dim)) * bsz, tiles, sms,
        blocks_per_sm, least=-(-tiles // FLASH_MAX_SEGMENT_TILES))


def flash_segments_on(device, bsz: int, n: int, m: int, heads: int,
                      dim: int = 16) -> int:
    """flash_segments for the built kernel instance (dim, heads) on the
    card `device` (its tiling and blocks per SM asked from the library
    once)."""
    per_sm = _build.kernel_tiles(
        _build.library("flash_cross_attention.cu").flash_cross_attention_tiles,
        (flash_queries_per_block(heads, dim), FLASH_KEY_TILE,
         FLASH_MAX_SEGMENT_TILES), "flash_cross_attention", dim, heads)
    return flash_segments(bsz, n, m, heads, _build.sm_count(device), per_sm,
                          dim)


# csrc/flash_cross_attention_bwd.cu's tiling (checked against the built
# kernels): rows per block (queries of the dq kernel, keys of the dkv
# kernel) and walked rows per tile (keys, queries); the most tiles one
# segment walks is FLASH_MAX_SEGMENT_TILES, as in the forward
FLASH_BWD_ROWS, FLASH_BWD_TILE = 64, 32


def flash_backward_segments(bsz: int, n: int, m: int, sms: int,
                            per_sm_dq: int, per_sm_dkv: int) -> tuple:
    """(Gq, Gkv): the number of segments the backward's dq kernel splits
    its key walk into and the dkv kernel its query walk
    (_build.plan_segments over each kernel's blocks x B and walked
    tiles, each with the blocks per SM its build reports): at least two
    blocks on each of `sms` SMs, no segment walking more than
    FLASH_MAX_SEGMENT_TILES tiles. Segment g takes the tiles
    _build.segment_tiles(tiles, G, g)."""
    def plan(rows, walked, per_sm):
        tiles = -(-walked // FLASH_BWD_TILE)
        return _build.plan_segments(
            -(-rows // FLASH_BWD_ROWS) * bsz, tiles, sms, per_sm,
            least=-(-tiles // FLASH_MAX_SEGMENT_TILES))
    # the dkv kernel walks the queries padded to whole dq blocks
    n_pad = -(-n // FLASH_BWD_ROWS) * FLASH_BWD_ROWS
    return plan(n, m, per_sm_dq), plan(m, n_pad, per_sm_dkv)


def flash_backward_segments_on(device, bsz: int, n: int, m: int,
                               heads: int, dim: int = 16) -> tuple:
    """flash_backward_segments for the built kernel instances (dim,
    heads) on the card `device` (their tiling and blocks per SM asked
    once)."""
    lib = _build.library("flash_cross_attention_bwd.cu")
    per_sm = [_build.kernel_tiles(
        lib.flash_cross_attention_bwd_tiles,
        (FLASH_BWD_ROWS, FLASH_BWD_TILE, FLASH_MAX_SEGMENT_TILES),
        f"flash_cross_attention_backward[{which}]", dim, heads, which)
        for which in (0, 1)]
    return flash_backward_segments(bsz, n, m, _build.sm_count(device),
                                   *per_sm)


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
    if dim not in FLASH_DIMS:
        raise ValueError(f"the flash kernels take head dims {FLASH_DIMS}, "
                         f"got {dim} (ROADMAP.md, section 2, TPU kernels, "
                         "lists the head dims they take)")
    if n == 0 or m == 0:
        raise ValueError(f"empty attention: {n} queries, {m} keys")
    if any(t.dtype != torch.float32 for t in (q, k, v)) \
            or kv_valid.dtype != torch.bool:
        raise TypeError("q, k, v must be float32 and kv_valid bool")
    if not (k.device == v.device == kv_valid.device == q.device):
        raise ValueError("q, k, v, kv_valid must be on one device")
    # the kernels read whole tokens as 16-byte vectors
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x.contiguous() for x in (q, k, v, kv_valid)))


def _fold_heads(x):
    """(B, N, D, H) -> (B H, N, D, 1): each head a frame of its own
    (frame b H + h), contiguous."""
    b, n, d, h = x.shape
    # reshape alone gives a strided view when B = 1: the copy is needed
    return x.permute(0, 3, 1, 2).reshape(b * h, n, d, 1).contiguous()


def _unfold_heads(x, heads: int):
    """The inverse of _fold_heads."""
    bh, n, d, _ = x.shape
    return x.reshape(bh // heads, heads, n, d).permute(0, 2, 3, 1) \
        .contiguous()


def _fold_lse(lse):
    """(B, N, H) -> (B H, N, 1), as _fold_heads orders the frames."""
    b, n, h = lse.shape
    return lse.permute(0, 2, 1).reshape(b * h, n, 1).contiguous()


def _unfold_lse(lse, heads: int):
    bh, n, _ = lse.shape
    return lse.reshape(bh // heads, heads, n).permute(0, 2, 1).contiguous()


def _forward_kernel(q, k, v, kv_valid, sm_scale: float, with_lse: bool,
                    segments: int | None = None, *, instance=None):
    """Launch the forward on contiguous, checked CUDA inputs; returns
    (out, lse (B, N, H) or None). `segments` overrides the planned key
    split (a check of the unsplit path). `instance` is the caller's
    (dim, heads) when the heads were folded into frames."""
    bsz, n, dim, heads = q.shape
    m = k.shape[1]
    if heads not in FLASH_HEADS:
        raise ValueError(f"forward kernel takes {FLASH_HEADS} heads, got "
                         f"{heads}")
    if dim * heads > FLASH_MAX_TOKEN:
        out, lse = _forward_kernel(
            *(_fold_heads(t) for t in (q, k, v)),
            kv_valid.repeat_interleave(heads, 0), sm_scale, with_lse,
            segments, instance=(dim, heads))
        return (_unfold_heads(out, heads),
                None if lse is None else _unfold_lse(lse, heads))
    lib = _build.library("flash_cross_attention.cu")
    if segments is None:
        segments = flash_segments_on(q.device, bsz, n, m, heads, dim)
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
    _build.count_launch("flash_cross_attention", instance or (dim, heads))
    return out, lse


def _backward_kernel(q, k, v, kv_valid, sm_scale: float, out, lse, dout,
                     segments: tuple | None = None, *, instance=None):
    """Launch the backward on checked CUDA inputs; returns (dq, dk, dv).
    `segments` = (Gq, Gkv) overrides the planned splits (a check of the
    unsplit path). `instance` as for _forward_kernel."""
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[1], q.shape[3]):
        raise ValueError(f"bad shapes out{tuple(out.shape)} "
                         f"dout{tuple(dout.shape)} lse{tuple(lse.shape)}")
    if any(t.dtype != torch.float32 or t.device != q.device
           for t in (out, lse, dout)):
        raise TypeError("out, lse, dout must be float32 on q's device")
    bsz, n, dim, heads = q.shape
    m = k.shape[1]
    if heads not in FLASH_HEADS:
        raise ValueError(f"backward kernel takes {FLASH_HEADS} heads, got "
                         f"{heads}")
    if dim * heads > FLASH_MAX_TOKEN:
        grads = _backward_kernel(
            *(_fold_heads(t) for t in (q, k, v)),
            kv_valid.repeat_interleave(heads, 0), sm_scale,
            _fold_heads(out), _fold_lse(lse), _fold_heads(dout), segments,
            instance=(dim, heads))
        return tuple(_unfold_heads(t, heads) for t in grads)
    # out and dout are read as whole tokens (16-byte vectors) too
    out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (out.contiguous(), dout.contiguous()))
    lse = lse.contiguous()
    lib = _build.library("flash_cross_attention_bwd.cu")
    seg_q, seg_kv = segments or flash_backward_segments_on(q.device, bsz, n,
                                                           m, heads, dim)
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # per (query, head) (L log2 e, D) and per 32 queries a word of live
    # rows, for queries padded to whole dq blocks; the segments' partial
    # dq or (dk, dv), merged in segment order by the kernel's last passes
    n_pad = -(-n // FLASH_BWD_ROWS) * FLASH_BWD_ROWS
    ld = torch.empty((bsz, n_pad, heads, 2), dtype=torch.float32, device=dev)
    words = torch.empty((bsz, n_pad // FLASH_BWD_TILE), dtype=torch.int32,
                        device=dev)
    part_q = (torch.empty((bsz, seg_q, n, dim * heads), dtype=torch.float32,
                          device=dev) if seg_q > 1 else None)
    part_k, part_v = ((torch.empty((bsz, seg_kv, m, dim * heads),
                                   dtype=torch.float32, device=dev)
                       for _ in range(2)) if seg_kv > 1 else (None, None))
    code = lib.flash_cross_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), ld.data_ptr(),
        words.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (part_q, part_k,
                                                         part_v)),
        bsz, n, m, dim, heads, seg_q, seg_kv, float(sm_scale),
        _build.stream_ptr(dev))
    _build.check(code, "flash_cross_attention_backward")
    _build.count_launch("flash_cross_attention_backward",
                        instance or (dim, heads))
    return dq, dk, dv


def flash_cross_attention_backward(q, k, v, kv_valid, sm_scale: float, out,
                                   lse, dout):
    """(dq, dk, dv) of the attention for the upstream gradient dout
    (B, N, dim, H), given the forward's out and lse (B, N, H). CPU
    tensors take the plain version (out and lse are not needed)."""
    if q.device.type == "cpu":
        return flash_cross_attention_backward_plain(q, k, v, kv_valid,
                                                    sm_scale, dout)
    return _backward_kernel(*_checked(q, k, v, kv_valid), sm_scale, out, lse,
                            dout)


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
