"""Fused masked cdist -> argmin / top-k (kernel: csrc/masked_cdist.cu).

Port of pose6d_tpu/ops/pallas/cdist.py (masked_argmin_cdist :40,
masked_topk_cdist :99). Each is a torch.library op
(pose6d_tpu_torch::masked_topk_cdist, ::masked_argmin_cdist), so the
dispatcher picks the implementation from the tensors' device at run
time and torch.export records the op as one node: on CUDA tensors the
hand-written kernel, on CPU tensors the plain PyTorch version beside
it, which reproduces the JAX package's XLA path
(pose6d_tpu/ops/nn.py:33-82) exactly: up to k = 8 the k-pass, which
returns the duplicate (1e9, column 0) once a row's valid columns run
out; above 8 lax.top_k, which returns the masked columns there, lowest
index first, at 1e9.
"""
from __future__ import annotations

import torch

from ..geometry import pairwise_sqdist
from ..masking import BIG
from . import _build

# the top-k lengths of the kernel's list instances: a call with k <= 16
# takes the smallest instance K >= k and keeps its first k columns (a
# row's top-k is the k-prefix of its top-K, the plain k-pass's (1e9, 0)
# fill too); a k above 16 takes the kernel's wide path, any k <= M
TOPK_INSTANCES = (1, 5, 8, 16)
# the JAX package's topk_valid: the k-pass up to this k, lax.top_k above
KPASS_MAX_K = 8
# features above this run a chunked walk, with list instances up to
# KPASS_MAX_K and the wide path above
CHUNKED_C = 64
# csrc/masked_cdist.cu's wide kernel keeps the distances of its 8 rows
# in shared memory where they fit: WIDE_SMEM_FIXED bytes of stage
# buffers and row norms plus WIDE_SMEM_PER_COLUMN a column (the wrapper
# checks the formula against the built kernel); else each walk it takes
# recomputes them
WIDE_SMEM_FIXED, WIDE_SMEM_PER_COLUMN = 66592, 32
WIDE_ROUTES = ("wide", "wide_walk")


def wide_route(m: int, smem_optin: int) -> str:
    """The wide kernel's route at M columns on a card whose blocks may
    opt in to `smem_optin` bytes of shared memory (the device property
    shared_memory_per_block_optin; 232448 on an H100): "wide" keeps each
    row's M distances in shared memory, computed once; "wide_walk"
    recomputes them in each walk it takes (any M)."""
    fits = WIDE_SMEM_FIXED + WIDE_SMEM_PER_COLUMN * m <= smem_optin
    return WIDE_ROUTES[0] if fits else WIDE_ROUTES[1]


def topk_instance(k: int, c: int = 1) -> int:
    """The kernel instance K that serves a top-k call at feature width
    c: a list instance for k <= 16 (k <= 8 above CHUNKED_C features),
    the wide path (K = k) above."""
    top = TOPK_INSTANCES[-1] if c <= CHUNKED_C else KPASS_MAX_K
    for inst in TOPK_INSTANCES:
        if k <= inst <= top:
            return inst
    return k


def _masked_sqdist(a, b, b_valid):
    d2 = pairwise_sqdist(a, b)
    return torch.where(b_valid[:, None, :], d2, torch.full_like(d2, BIG))


def masked_topk_cdist_plain(a, b, b_valid, k: int):
    """k successive masked argmin passes (first index wins ties), as
    the XLA k-pass of pose6d_tpu/ops/nn.py:67-80; above k = 8 a stable
    ascending sort, as lax.top_k of the negated distances there."""
    cur = _masked_sqdist(a, b, b_valid)
    if k > KPASS_MAX_K:
        if k > cur.shape[-1]:
            raise ValueError(f"top-k with k={k} > {cur.shape[-1]} columns")
        d2, idx = torch.sort(cur, dim=-1, stable=True)
        return d2[..., :k], idx[..., :k].to(torch.int32)
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
    (B, N) each for k = 1 with squeeze, and the launched instance (K,
    route) for the launch counts (route "tiled" at C <= 64, "chunked"
    above, or wide_route's for the wide path). The
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
    if c < 1 or k < 1 or n == 0 or m == 0:
        raise ValueError(f"kernel takes C >= 1, k >= 1 and rows: C={c} k={k} "
                         f"N={n} M={m}")
    inst = topk_instance(k, c)
    wide = inst == k > KPASS_MAX_K and (inst > TOPK_INSTANCES[-1]
                                        or c > CHUNKED_C)
    if wide and k > m:
        raise ValueError(f"top-k with k={k} > {m} columns")
    a, b, valid = (x if x.stride(-1) == 1 else x.contiguous()
                   for x in (a, b, b_valid))
    lib = _build.library("masked_cdist.cu")
    splits = lib.masked_topk_cdist_splits(bsz, n, m, c, inst,
                                          _build.sm_count(a.device))
    route = "chunked" if c > CHUNKED_C else "tiled"
    if wide:
        route = wide_route(m, _smem_optin(a.device))
        want = WIDE_SMEM_FIXED + WIDE_SMEM_PER_COLUMN * m
        if route == "wide" and lib.masked_topk_cdist_wide_smem(m, 1) != want:
            raise RuntimeError("masked_topk_cdist: the wide kernel's shared "
                               "memory is not the wrapper's "
                               f"{WIDE_SMEM_FIXED} + {WIDE_SMEM_PER_COLUMN} M")
    if splits < 1:
        raise RuntimeError(f"masked_topk_cdist: no kernel instance K={inst}")
    shape = (bsz, n) if squeeze else (bsz, n, inst)
    d2 = torch.empty(shape, dtype=torch.float32, device=a.device)
    idx = torch.empty(shape, dtype=torch.int32, device=a.device)
    # partial lists of the column segments (merged by the kernel's
    # second pass), only when the columns are split across blocks; the
    # wide path's (B, N, k) scratch of unsorted winners
    part_d2 = part_idx = None
    if splits > 1 or wide:
        part_d2 = torch.empty((bsz, splits, n, inst), dtype=torch.float32,
                              device=a.device)
        part_idx = torch.empty_like(part_d2, dtype=torch.int32)
    code = lib.masked_topk_cdist_f32(
        a.data_ptr(), b.data_ptr(), valid.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), None if part_d2 is None else part_d2.data_ptr(),
        None if part_idx is None else part_idx.data_ptr(), bsz, n, m, c, inst,
        splits, WIDE_ROUTES.index(route) if wide else 0, a.stride(0),
        a.stride(1), b.stride(0), b.stride(1), valid.stride(0),
        _build.stream_ptr(a.device))
    _build.check(code, "masked_topk_cdist")
    if inst != k:
        d2, idx = d2[..., :k].contiguous(), idx[..., :k].contiguous()
    if k > KPASS_MAX_K and not wide:
        idx = _top_k_fill(d2, idx, valid)
    return d2, idx, (inst, route)


def _smem_optin(device) -> int:
    """The shared memory a block of the card may opt in to, in bytes."""
    return torch.cuda.get_device_properties(
        torch.device(device)).shared_memory_per_block_optin


def _top_k_fill(d2, idx, b_valid):
    """lax.top_k's indices where a row's valid columns ran out: the
    kernel's list instances leave (1e9, 0) there, top_k the masked
    columns in increasing order (each frame's, the same for all its
    rows). The wide path writes them so itself."""
    if b_valid.shape[-1] < idx.shape[-1]:
        raise ValueError(f"top-k with k={idx.shape[-1]} > "
                         f"{b_valid.shape[-1]} columns")
    masked = torch.argsort(b_valid.to(torch.int8), dim=-1, stable=True)
    live = (d2 < BIG).sum(-1, keepdim=True)
    slot = torch.arange(idx.shape[-1], device=idx.device) - live
    fill = torch.gather(masked, 1, slot.clamp(min=0).flatten(1)).view_as(idx)
    return torch.where(slot >= 0, fill.to(torch.int32), idx)


@torch.library.custom_op("pose6d_tpu_torch::masked_topk_cdist",
                         mutates_args=(), device_types="cpu")
def _topk_op(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous()
                 for t in masked_topk_cdist_plain(a, b, b_valid, k))


@_topk_op.register_kernel("cuda")
def _(a, b, b_valid, k):
    d2, idx, instance = _launch(a, b, b_valid, k)
    _build.count_launch("masked_topk_cdist", instance)
    return d2, idx


@_topk_op.register_fake
def _(a, b, b_valid, k):
    shape = (*a.shape[:-1], k)
    return a.new_empty(shape), a.new_empty(shape, dtype=torch.int32)


@torch.library.custom_op("pose6d_tpu_torch::masked_argmin_cdist",
                         mutates_args=(), device_types="cpu")
def _argmin_op(a: torch.Tensor, b: torch.Tensor,
               b_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return masked_argmin_cdist_plain(a, b, b_valid)


@_argmin_op.register_kernel("cuda")
def _(a, b, b_valid):
    d2, idx, instance = _launch(a, b, b_valid, 1, squeeze=True)
    _build.count_launch("masked_argmin_cdist", instance)
    return d2, idx


@_argmin_op.register_fake
def _(a, b, b_valid):
    shape = a.shape[:-1]
    return a.new_empty(shape), a.new_empty(shape, dtype=torch.int32)


def masked_topk_cdist(a, b, b_valid, k: int = 5):
    """k smallest masked ||a_i - b_j||^2 per row, ascending, ties to the
    lower index. a (B, N, C), b (B, M, C), b_valid (B, M) bool.
    Returns (d2 (B, N, k), idx (B, N, k) int32). Any k (at most M
    above 8, as lax.top_k) and any C."""
    return _topk_op(a, b, b_valid, k)


def masked_argmin_cdist(a, b, b_valid):
    """Masked nearest neighbour: (d2_min (B, N), idx (B, N) int32)."""
    return _argmin_op(a, b, b_valid)
