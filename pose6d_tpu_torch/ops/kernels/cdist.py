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
import torch.nn.functional as F

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


def _launch(a, b, b_valid, k: int):
    """Kernel launch: a (B, N, C), b (B, M, C) f32, b_valid (B, M) bool
    on one CUDA device -> (d2 (B, N, k), idx (B, N, k) int32)."""
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
    if c > 32 or k not in (1, 5) or n == 0 or m == 0:
        raise ValueError(f"kernel takes C <= 32, k in (1, 5): C={c} k={k}")
    cp = 4 if c <= 4 else 32   # zero feature columns change no distance
    a_p = F.pad(a, (0, cp - c)).contiguous()
    b_p = F.pad(b, (0, cp - c)).contiguous()
    valid = b_valid.contiguous()
    d2 = torch.empty((bsz, n, k), dtype=torch.float32, device=a.device)
    idx = torch.empty((bsz, n, k), dtype=torch.int32, device=a.device)
    lib = _build.library("masked_cdist.cu")
    code = lib.masked_topk_cdist_f32(
        a_p.data_ptr(), b_p.data_ptr(), valid.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), bsz, n, m, cp, k, _build.stream_ptr(a.device))
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
    d2, idx = _launch(a, b, b_valid, 1)
    _build.LAUNCHES["masked_argmin_cdist"] += 1
    return d2[..., 0], idx[..., 0]
