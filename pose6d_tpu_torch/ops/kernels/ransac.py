"""RANSAC's hypothesis scoring (kernel: csrc/ransac_inlier_counts.cu).

Replaces no TPU kernel: the JAX package scores hypotheses in plain XLA.
It is a torch.library op (pose6d_tpu_torch::ransac_inlier_counts): the
dispatcher runs the hand-written kernel on CUDA tensors and the plain
PyTorch version beside it on CPU tensors. The kernel keeps each
residual in registers where the plain version writes (B, H, N) planes,
and skips frames that have exited; its counts equal the plain
version's bit for bit.
"""
from __future__ import annotations

import torch

from . import _build

# csrc/ransac_inlier_counts.cu's tiling (checked against the built
# kernel): hypotheses per block, pairs per staged tile
RANSAC_HYP_TILE, RANSAC_PAIR_TILE = 128, 256


def ransac_segments(bsz: int, h: int, n: int, sms: int,
                    blocks_per_sm: int) -> int:
    """The number of pair segments S the kernel splits its pair walk into
    (_build.plan_segments over its hypothesis blocks x B and its pair
    tiles): at least two blocks on each of `sms` SMs. Segment s takes the
    pair tiles _build.segment_tiles(tiles, S, s)."""
    return _build.plan_segments(-(-h // RANSAC_HYP_TILE) * bsz,
                                -(-n // RANSAC_PAIR_TILE), sms, blocks_per_sm)


def ransac_segments_on(device, bsz: int, h: int, n: int) -> int:
    """ransac_segments for the built kernel on the card `device` (its
    tiling and blocks per SM asked from the library once)."""
    per_sm = _build.kernel_tiles(
        _build.library("ransac_inlier_counts.cu").ransac_inlier_counts_tiles,
        (RANSAC_HYP_TILE, RANSAC_PAIR_TILE), "ransac_inlier_counts")
    return ransac_segments(bsz, h, n, _build.sm_count(device), per_sm)


def ransac_inlier_counts_plain(Rs, ts, src, dst, vmask, thr2, active):
    """Inlier counts from the (B, H, N) residual planes, the 3-wide
    contraction unrolled; rows of inactive frames 0."""
    d2 = torch.zeros((*Rs.shape[:2], src.shape[1]), dtype=torch.float32,
                     device=src.device)
    for i in range(3):
        pred_i = (Rs[:, :, i, 0, None] * src[:, None, :, 0]
                  + Rs[:, :, i, 1, None] * src[:, None, :, 1]
                  + Rs[:, :, i, 2, None] * src[:, None, :, 2]
                  + ts[:, :, i, None])
        d2 = d2 + (pred_i - dst[:, None, :, i]) ** 2
    counts = ((d2 < thr2[:, None, None]) * vmask[:, None]).sum(-1)
    return torch.where(active[:, None], counts, 0.0)


def _ransac_launch(Rs, ts, src, dst, vmask, thr2, active):
    """Kernel launch on CUDA tensors (the op's CUDA implementation)."""
    bsz, h = Rs.shape[:2]
    n = src.shape[1]
    if (Rs.shape != (bsz, h, 3, 3) or ts.shape != (bsz, h, 3)
            or src.shape != (bsz, n, 3) or dst.shape != (bsz, n, 3)
            or vmask.shape != (bsz, n) or thr2.shape != (bsz,)
            or active.shape != (bsz,)):
        raise ValueError(
            f"bad shapes Rs{tuple(Rs.shape)} ts{tuple(ts.shape)} "
            f"src{tuple(src.shape)} dst{tuple(dst.shape)} "
            f"vmask{tuple(vmask.shape)} thr2{tuple(thr2.shape)} "
            f"active{tuple(active.shape)}")
    if h == 0 or n == 0 or n >= 2 ** 24:
        raise ValueError(f"kernel takes 1 <= H and 1 <= N < 2^24: H={h}, "
                         f"N={n}")
    if any(t.dtype != torch.float32 for t in (Rs, ts, src, dst, vmask, thr2)):
        raise TypeError("Rs, ts, src, dst, vmask, thr2 must be float32")
    if active.dtype != torch.bool:
        raise TypeError("active must be bool")
    if any(t.device != Rs.device for t in (ts, src, dst, vmask, thr2,
                                           active)):
        raise ValueError("every input must be on one device")
    Rs, ts, src, dst, vmask, thr2, active = (
        t.contiguous() for t in (Rs, ts, src, dst, vmask, thr2, active))
    lib = _build.library("ransac_inlier_counts.cu")
    segments = ransac_segments_on(Rs.device, bsz, h, n)
    counts = torch.empty((bsz, h), dtype=torch.float32, device=Rs.device)
    code = lib.ransac_inlier_counts_f32(
        Rs.data_ptr(), ts.data_ptr(), src.data_ptr(), dst.data_ptr(),
        vmask.data_ptr(), thr2.data_ptr(), active.data_ptr(),
        counts.data_ptr(), bsz, h, n, segments, _build.stream_ptr(Rs.device))
    _build.check(code, "ransac_inlier_counts")
    _build.count_launch("ransac_inlier_counts")
    return counts


@torch.library.custom_op("pose6d_tpu_torch::ransac_inlier_counts",
                         mutates_args=(), device_types="cpu")
def _ransac_op(Rs: torch.Tensor, ts: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, vmask: torch.Tensor, thr2: torch.Tensor,
               active: torch.Tensor) -> torch.Tensor:
    return ransac_inlier_counts_plain(Rs, ts, src, dst, vmask, thr2, active)


_ransac_op.register_kernel("cuda")(_ransac_launch)


@_ransac_op.register_fake
def _(Rs, ts, src, dst, vmask, thr2, active):
    return Rs.new_empty(Rs.shape[:2])


def ransac_inlier_counts(Rs, ts, src, dst, vmask, thr2, active):
    """Rs (B, H, 3, 3), ts (B, H, 3) hypotheses; src, dst (B, N, 3) f32
    pairs; vmask (B, N) f32, 1 for a valid pair and 0 otherwise; thr2
    (B,) f32 squared inlier distance; active (B,) bool. Returns (B, H) f32
    counts of the valid pairs with |R src + t - dst|^2 < thr2, 0 on the
    rows of inactive frames."""
    return _ransac_op(Rs, ts, src, dst, vmask, thr2, active)
