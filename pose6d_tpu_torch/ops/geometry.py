"""Mask erosion, depth backprojection, statistical outlier removal,
pairwise distances and GT correspondence masks (port of
pose6d_tpu/ops/geometry.py). Every function takes leading batch
dimensions and runs on the device of its inputs.
"""
from __future__ import annotations

import torch

from .masking import BIG, masked_mean


def pairwise_sqdist(a, b):
    """Squared Euclidean distances, (..., N, C) x (..., M, C) -> (..., N, M).

    Uses the |a|^2 - 2ab + |b|^2 expansion, clamped at 0, as the JAX
    package does (full f32: TF32 is off, see runtime.configure).
    """
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 - 2.0 * cross + b2.transpose(-1, -2), min=0.0)


def fma_f32(a, b, c):
    """a * b + c rounded to f32 as a fused multiply-add rounds it: the
    product of two f32 values is exact in float64, whose arithmetic is
    correctly rounded on every device (c is read as f32 and widened
    inside the kernel). The sum's own float64 rounding makes this differ
    from a true FMA only when that sum lands on an f32 rounding midpoint
    (about 2^-29 of random inputs); every device still agrees."""
    return torch.addcmul(c, a.double(), b.double()).float()


def pairwise_sqdist_fma(a, b):
    """pairwise_sqdist with the arithmetic that the JAX package's jitted
    expansion compiles to on the CPU: |a|^2 and a . b as chains of fused
    multiply-adds, then (|a|^2 - 2 a . b) + |b|^2, clamped at 0. Built
    from elementwise products and sums (no matrix product), it gives the
    same bits on every device. (..., N, 3) x (..., M, 3) -> (..., N, M).

    The expansion cancels to ~1e-3 of a squared neighbour distance on
    depth-frame clouds ~1 m away, so a kNN threshold read from it
    depends on these bits; two devices that round it differently keep
    different points."""
    a = a.float()
    b = b.float()

    def sq(x):
        x0, x1, x2 = x.unbind(-1)
        return fma_f32(x2, x2, fma_f32(x1, x1, x0 * x0))

    ai = a[..., :, None, :].unbind(-1)
    bj = b[..., None, :, :].unbind(-1)
    cross = fma_f32(ai[2], bj[2], fma_f32(ai[1], bj[1], ai[0] * bj[0]))
    d2 = cross.mul_(-2.0).add_(sq(a)[..., :, None]).add_(sq(b)[..., None, :])
    return d2.clamp_(min=0.0)


def radius_correspondence_mask(cad, cad_valid, pc, pc_valid, radius):
    """Dense boolean GT-correspondence mask (..., V1, V2): valid pairs
    within `radius` (compared as d2 <= radius^2 in f32, as the JAX
    function does, on the distances of its jitted expansion: the same
    pairs on every device)."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=cad.device)
    d2 = pairwise_sqdist_fma(cad, pc)
    ok = cad_valid[..., :, None] & pc_valid[..., None, :]
    return ok & (d2 <= r * r)


def overlap_from_mask(corr_mask):
    """overlap_12 (..., V1), overlap_21 (..., V2) from the dense mask."""
    return corr_mask.any(-1), corr_mask.any(-2)


def erode_mask(mask, kernel_size: int = 3):
    """Binary erosion of (..., H, W) masks by a square kernel minus its 4
    corners (cv2.erode as the reference calls it). A pixel survives iff
    every pixel under the kernel is set; pixels outside the image count
    as set."""
    k = kernel_size
    r = k // 2
    m = mask.bool()
    h, w = m.shape[-2:]
    padded = torch.nn.functional.pad(m, (r, r, r, r), value=True)
    out = torch.ones_like(m)
    corner = {(0, 0), (0, k - 1), (k - 1, 0), (k - 1, k - 1)}
    for dy in range(k):
        for dx in range(k):
            if k > 1 and (dy, dx) in corner:
                continue
            out = out & padded[..., dy:dy + h, dx:dx + w]
    return out


def backproject_depth(depth, K, cam_scale, mask, max_points: int,
                      kernel_size: int = 3):
    """Masked depth pixels -> a fixed-size point buffer, in the
    reference's convention: the mask is eroded, then pixel (i, j) gives
    [(j - cx) z / fx, (i - cy) z / fy, z] * 100 with z = depth / cam_scale.

    depth (B, H, W), K (B, 3, 3), cam_scale (B,) or scalar, mask
    (B, H, W). The first max_points masked pixels in row-major order are
    kept (jnp.nonzero(size=max_points) in the JAX package, truncation
    included), by a cumsum compaction that never syncs the host.
    Returns points (B, max_points, 3) f32 and valid (B, max_points).
    """
    bsz, h, w = depth.shape
    dev = depth.device
    m = erode_mask(mask, kernel_size).reshape(bsz, h * w)
    # divisors as tensors on the device: CUDA turns a division by a host
    # scalar into a product with its reciprocal, which rounds otherwise
    scale = torch.as_tensor(cam_scale, dtype=torch.float32,
                            device=dev).expand(bsz)[:, None, None]
    K = K.to(device=dev, dtype=torch.float32)
    z = depth.float() / scale
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    x = (cols - K[:, 0, 2, None, None]) * z / K[:, 0, 0, None, None]
    y = (rows - K[:, 1, 2, None, None]) * z / K[:, 1, 1, None, None]
    pts = torch.stack([x, y, z], dim=-1).reshape(bsz, h * w, 3) * 100.0
    # slot of each masked pixel among the masked ones; the rest (and
    # masked pixels past max_points) go to an overflow slot that is cut
    slot = torch.cumsum(m, dim=1) - 1
    slot = torch.where(m & (slot < max_points), slot,
                       torch.full_like(slot, max_points))
    idx = torch.full((bsz, max_points + 1), h * w, dtype=torch.int64,
                     device=dev)
    idx.scatter_(1, slot, torch.arange(h * w, device=dev).expand(bsz, -1))
    idx = idx[:, :max_points]
    valid = idx < h * w
    safe = torch.clamp(idx, max=h * w - 1)
    points = torch.gather(pts, 1, safe[..., None].expand(-1, -1, 3))
    return torch.where(valid[..., None], points, 0.0), valid


def statistical_outlier_mask(points, valid, nb_neighbors: int = 20,
                             std_ratio: float = 0.3, block: int = 2048):
    """Keep-mask of statistical outlier removal (Open3D's
    remove_statistical_outlier) on padded (B, N, 3) point sets.

    A valid point is kept iff the mean distance to its nb_neighbors
    nearest valid neighbours (itself excluded) is at most mean +
    std_ratio * std of that quantity over the frame's valid points.
    The kNN runs `block` rows at a time, so the (N, N) distance matrix
    is never built; rows short of neighbours carry BIG sentinels, which
    the mean leaves out.
    """
    n = points.shape[1]
    nb = nb_neighbors
    col = torch.arange(n, device=points.device)
    parts = []
    for s in range(0, n, block):
        rp, rv = points[:, s:s + block], valid[:, s:s + block]
        d2 = pairwise_sqdist_fma(rp, points)
        rows = torch.arange(s, s + rp.shape[1], device=points.device)
        bad = ~(rv[:, :, None] & valid[:, None, :]) | (
            col[None, None, :] == rows[None, :, None])
        neg = torch.where(bad, -BIG, -d2)
        parts.append(torch.topk(neg, nb, dim=-1).values)
    neg = torch.cat(parts, dim=1)
    knn_d = torch.sqrt(torch.clamp(-neg, min=0.0))
    finite = -neg < BIG * 0.5
    mean_d = masked_mean(knn_d, finite, dim=-1)
    mu = masked_mean(mean_d, valid, dim=-1)[:, None]
    var = masked_mean((mean_d - mu) ** 2, valid, dim=-1)[:, None]
    thresh = mu + std_ratio * torch.sqrt(torch.clamp(var, min=0.0))
    return valid & (mean_d <= thresh)
