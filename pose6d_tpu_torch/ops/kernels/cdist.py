"""Fused masked cdist -> argmin / top-k (kernel: csrc/masked_cdist.cu).

Port of pose6d_tpu/ops/pallas/cdist.py (masked_argmin_cdist :40,
masked_topk_cdist :99). For a CUDA tensor the wrapper launches the
hand-written kernel; for a CPU tensor it runs the plain PyTorch version
beside it, which reproduces the JAX package's XLA path
(pose6d_tpu/ops/nn.py:33-82) exactly, including the duplicate column 0
that the k-pass returns when a row has fewer than k valid columns.
"""
from __future__ import annotations

import torch

from ..geometry import pairwise_sqdist
from ..masking import BIG
from . import _build


def _masked_sqdist(a, b, b_valid):
    d2 = pairwise_sqdist(a, b)
    return torch.where(b_valid[:, None, :], d2, torch.full_like(d2, BIG))


def masked_topk_cdist_plain(a, b, b_valid, k: int):
    """k successive masked argmin passes (first index wins ties), as
    the XLA k-pass of pose6d_tpu/ops/nn.py:67-80."""
    cur = _masked_sqdist(a, b, b_valid)
    ds, idxs = [], []
    for _ in range(k):
        i = torch.argmin(cur, dim=-1, keepdim=True)
        ds.append(torch.gather(cur, -1, i)[..., 0])
        idxs.append(i[..., 0].to(torch.int32))
        cur = cur.scatter(-1, i, BIG)
    return torch.stack(ds, dim=-1), torch.stack(idxs, dim=-1)


def masked_argmin_cdist_plain(a, b, b_valid):
    d2 = _masked_sqdist(a, b, b_valid)
    return d2.min(dim=-1).values, torch.argmin(d2, dim=-1).to(torch.int32)


def _launch(a, b, b_valid, k: int, squeeze: bool = False):
    """Kernel launch: a (B, N, C), b (B, M, C) f32, b_valid (B, M) bool
    on one CUDA device -> (d2 (B, N, k), idx (B, N, k) int32), or
    (B, N) each for k = 1 with squeeze. The
    kernel reads a and b through their batch and row strides and pads
    the features itself, so a slice such as evecs[..., :30] is not
    copied; a tensor whose last dimension is strided is."""
    if a.dim() != 3 or b.dim() != 3 or b_valid.shape != b.shape[:2]:
        raise ValueError(f"bad shapes a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"b_valid{tuple(b_valid.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError("a and b differ in batch or feature size")
    if a.dtype != torch.float32 or b.dtype != torch.float32 \
            or b_valid.dtype != torch.bool:
        raise TypeError("a, b must be float32 and b_valid bool")
    if not (b.device == a.device == b_valid.device):
        raise ValueError("a, b, b_valid must be on one device")
    bsz, n, c = a.shape
    m = b.shape[1]
    if c > 64 or k not in (1, 5) or n == 0 or m == 0:
        raise ValueError(f"kernel takes C <= 64, k in (1, 5): C={c} k={k}")
    a, b, valid = (x if x.stride(-1) == 1 else x.contiguous()
                   for x in (a, b, b_valid))
    lib = _build.library("masked_cdist.cu")
    splits = lib.masked_topk_cdist_splits(bsz, n, m, c,
                                          _build.sm_count(a.device))
    shape = (bsz, n) if squeeze else (bsz, n, k)
    d2 = torch.empty(shape, dtype=torch.float32, device=a.device)
    idx = torch.empty(shape, dtype=torch.int32, device=a.device)
    # partial lists of the column segments (merged by the kernel's
    # second pass), only when the columns are split across blocks
    part_d2 = part_idx = None
    if splits > 1:
        part_d2 = torch.empty((bsz, splits, n, k), dtype=torch.float32,
                              device=a.device)
        part_idx = torch.empty_like(part_d2, dtype=torch.int32)
    code = lib.masked_topk_cdist_f32(
        a.data_ptr(), b.data_ptr(), valid.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), None if part_d2 is None else part_d2.data_ptr(),
        None if part_idx is None else part_idx.data_ptr(), bsz, n, m, c, k,
        splits, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        valid.stride(0), _build.stream_ptr(a.device))
    _build.check(code, "masked_topk_cdist")
    return d2, idx


def masked_topk_cdist(a, b, b_valid, k: int = 5):
    """k smallest masked ||a_i - b_j||^2 per row, ascending, ties to the
    lower index. a (B, N, C), b (B, M, C), b_valid (B, M) bool.
    Returns (d2 (B, N, k), idx (B, N, k) int32)."""
    if a.device.type == "cpu":
        return masked_topk_cdist_plain(a, b, b_valid, k)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _launch(a, b, b_valid, k)
    _build.LAUNCHES["masked_topk_cdist"] += 1
    return out


def masked_argmin_cdist(a, b, b_valid):
    """Masked nearest neighbour: (d2_min (B, N), idx (B, N) int32)."""
    if a.device.type == "cpu":
        return masked_argmin_cdist_plain(a, b, b_valid)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _launch(a, b, b_valid, 1, squeeze=True)
    _build.LAUNCHES["masked_argmin_cdist"] += 1
    return out
