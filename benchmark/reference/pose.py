"""Plain pose stages of the cached-operator path: the spatially filtered
point map, correspondence RANSAC and cloud-to-model ICP, as the
reference repository (m13ammed/6D-Pose-Estimation-for-Unseen-Categories)
defines them and the configurations state them. Written from that
description: it imports nothing of the program. Batched over a leading
B; every distance and solve in the reference's precision.

- Filter: each PC point's k nearest valid CAD points in the aligned
  spectral embedding (Phi_x C^T against Phi_y; the first index on ties),
  pairs in PC-major order (pc_point * k + rank); then pruning rounds of
  the mean |d(cad_i, cad_j) - d(pc_i, pc_j)| over the valid pairs i: a
  plain round for every tau but the last two, then the (tight,
  loose-fallback) final round, each tau times the CAD diameter.
- RANSAC: blocks of 3-point hypotheses drawn from each frame's valid
  pairs by slot = int(f32(u) * f32(n_valid)) (the draws' definition),
  each solved in closed form from two orthonormal frames, scored by the
  count of valid pairs within the threshold; the first best wins; a
  frame stops drawing once its best inlier ratio eps meets log(1 -
  0.999) / log(1 - eps^3) trials; two weighted least-squares refits on
  the inliers (SVD with the determinant fix), kept while >= 3 inliers.
- ICP: the observed cloud onto the CAD from the inverse of the given
  pose; every iteration pairs each cloud point with its nearest valid
  CAD point, gated at the correspondence distance, and takes the
  weighted rigid fit (kept while >= 3 pairs); all but the last
  `fine_iters` iterations against every coarse_stride-th CAD point; the
  rmse of the gated nearest distances at full resolution; the result
  inverted back to a model-to-camera pose.
"""
from __future__ import annotations

import math

import torch

from .precision import Prec

CONFIDENCE = 0.999
REFIT_ROUNDS = 2


def sqdist(a, b, prec: Prec):
    """(B, N, C) x (B, M, C) -> (B, N, M) squared distances (expansion)."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    return torch.clamp(a2 - 2.0 * prec.mm(a, b.transpose(-1, -2)) + b2,
                       min=0.0)


def _rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def spectral_candidates(C, evecs_x, evecs_y, x_valid, k: int, prec: Prec):
    """(B, V2, k) indices of each PC point's k nearest valid CAD points in
    the embedding, ascending, the first index on ties."""
    emb = prec.mm(evecs_x, C.transpose(-1, -2))
    d2 = sqdist(evecs_y, emb, prec)
    d2 = d2.masked_fill(~x_valid[:, None, :], math.inf)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def consistency_mean(ca, cb, w, prec: Prec, block: int = 2048):
    """mean over rows i with weight w_i of |d(ca_i, ca_j) - d(cb_i, cb_j)|,
    per column j. ca, cb (B, P, 3); w (B, P)."""
    out = torch.zeros(w.shape, dtype=ca.dtype, device=ca.device)
    for j in range(0, ca.shape[1], block):
        da = torch.sqrt(sqdist(ca[:, j:j + block], ca, prec))
        db = torch.sqrt(sqdist(cb[:, j:j + block], cb, prec))
        out[:, j:j + block] = prec.mm(torch.abs(da - db),
                                      w[..., None].to(ca.dtype))[..., 0]
    return out / torch.clamp(w.sum(-1, keepdim=True), min=1.0)


def spatial_filter(C, cad, pc, diam, n_fmap: int, k: int, taus, prec: Prec):
    """cad_idx (B, V2 * k) and valid (B, V2 * k), PC-major."""
    bsz, v2 = pc["valid"].shape
    top = spectral_candidates(C, cad["evecs"][..., :n_fmap],
                              pc["evecs"][..., :n_fmap], cad["valid"], k,
                              prec)
    cad_idx = top.reshape(bsz, -1)
    pc_idx = torch.arange(v2, device=C.device).repeat_interleave(k)
    ca = _rows(cad["xyz"], cad_idx)
    cb = _rows(pc["xyz"], pc_idx.expand(bsz, -1))
    valid = pc["valid"].repeat_interleave(k, dim=1)
    d = diam[:, None]
    for tau in taus[:-2]:
        valid = valid & (consistency_mean(ca, cb, valid, prec) < tau * d)
    m = consistency_mean(ca, cb, valid, prec)
    tight = valid & (m < taus[-2] * d)
    loose = valid & (m < taus[-1] * d)
    return cad_idx, torch.where(tight.any(-1, keepdim=True), tight, loose)


def rigid_fit(src, dst, w, prec: Prec):
    """Weighted least-squares rigid (R, t) with R src + t ~ dst (SVD)."""
    wn = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8))[..., None]
    mu_s, mu_d = (src * wn).sum(-2), (dst * wn).sum(-2)
    H = prec.mm((src - mu_s[..., None, :]).transpose(-1, -2),
                (dst - mu_d[..., None, :]) * wn)
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(prec.mm(V, Ut)))
    S = torch.diag_embed(torch.stack(
        [torch.ones_like(sign), torch.ones_like(sign), sign], -1))
    R = prec.mm(prec.mm(V, S), Ut)
    return R, mu_d - prec.mm(R, mu_s[..., None])[..., 0]


def triad(src3, dst3, prec: Prec):
    """Closed-form (R, t) of each 3-point sample (..., 3, 3), rows points:
    R = F(dst) F(src)^T with F the frame (edge, plane normal, cross)."""
    def frame(p):
        e1 = p[..., 1, :] - p[..., 0, :]
        e2 = p[..., 2, :] - p[..., 0, :]
        u1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        n = torch.linalg.cross(e1, e2, dim=-1)
        u2 = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1,
                                                      keepdim=True),
                             min=1e-12)
        return torch.stack([u1, u2, torch.linalg.cross(u2, u1, dim=-1)], -1)

    R = prec.mm(frame(dst3), frame(src3).transpose(-1, -2))
    t = dst3.mean(-2) - prec.mm(R, src3.mean(-2)[..., None])[..., 0]
    return R, t


def residuals(R, t, src, dst, prec: Prec):
    return torch.linalg.vector_norm(
        prec.mm(src, R.transpose(-1, -2)) + t[..., None, :] - dst, dim=-1)


def ransac(src, dst, valid, threshold, uniforms, prec: Prec):
    """src, dst (B, N, 3); valid (B, N); threshold (B,); uniforms (B,
    n_blocks, block, 3) f32 draws. Returns R, t, n_inliers, n_trials."""
    bsz, n = valid.shape
    n_blocks, block = uniforms.shape[1:3]
    dev = src.device
    vmask = valid.to(src.dtype)
    n_valid = torch.clamp(vmask.sum(-1), min=1.0)
    valid_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    n_valid_i = valid.sum(-1)
    rows = torch.arange(bsz, device=dev)[:, None, None]
    thr2 = (threshold * threshold)[:, None, None]
    R = torch.eye(3, dtype=src.dtype, device=dev).repeat(bsz, 1, 1)
    t = torch.zeros((bsz, 3), dtype=src.dtype, device=dev)
    best = torch.zeros(bsz, dtype=src.dtype, device=dev)
    done = torch.zeros(bsz, dtype=torch.int64, device=dev)

    def required(best):
        eps = torch.clamp(best / n_valid, 0.0, 1.0)
        p_good = torch.clamp(eps ** 3, 1e-12, 1.0 - 1e-7)
        return math.log1p(-CONFIDENCE) / torch.log1p(-p_good)

    for blk in range(n_blocks):
        active = (done < n_blocks) & (done * block < required(best))
        if not bool(active.any()):
            break
        u = uniforms[:, blk].float()
        slots = (u * n_valid_i.float()[:, None, None]).to(torch.int64)
        slots = torch.minimum(slots, torch.clamp(n_valid_i - 1, min=0)
                              [:, None, None])
        samples = torch.gather(valid_idx, 1, slots.reshape(bsz, -1)
                               ).reshape(bsz, block, 3)
        Rs, ts = triad(src[rows, samples], dst[rows, samples], prec)
        pred = prec.mm(src[:, None], Rs.transpose(-1, -2)) + ts[:, :, None]
        d2 = ((pred - dst[:, None]) ** 2).sum(-1)
        counts = ((d2 < thr2) * vmask[:, None]).sum(-1)
        b = torch.argmax(counts, dim=-1)
        ar = torch.arange(bsz, device=dev)
        cb = counts[ar, b]
        better = active & (cb > best)
        R = torch.where(better[:, None, None], Rs[ar, b], R)
        t = torch.where(better[:, None], ts[ar, b], t)
        best = torch.where(active, torch.maximum(best, cb), best)
        done = done + active.to(torch.int64)
    for _ in range(REFIT_ROUNDS):
        w = ((residuals(R, t, src, dst, prec) < threshold[:, None])
             & valid).to(src.dtype)
        R2, t2 = rigid_fit(src, dst, w, prec)
        ok = w.sum(-1) >= 3
        R = torch.where(ok[:, None, None], R2, R)
        t = torch.where(ok[:, None], t2, t)
    inl = (residuals(R, t, src, dst, prec) < threshold[:, None]) & valid
    return {"R": R, "t": t, "n_inliers": inl.sum(-1),
            "n_trials": done * block}


def icp(cad, pc, R0, t0, max_corr, max_iter: int, coarse_stride: int,
        prec: Prec, fine_iters: int = 5):
    """Cloud-to-model ICP from the model-to-camera pose (R0, t0); returns
    the refined model-to-camera R, t and the rmse."""
    src, sv = pc["xyz"], pc["valid"]
    gate = (max_corr ** 2)[:, None]

    def nearest(R, t, tgt, tv):
        moved = prec.mm(src, R.transpose(-1, -2)) + t[:, None, :]
        d2 = sqdist(moved, tgt, prec).masked_fill(~tv[:, None, :], math.inf)
        dmin, j = d2.min(-1)
        return dmin, j, (sv & (dmin < gate)).to(src.dtype)

    def iterate(R, t, tgt, tv, n):
        for _ in range(n):
            _, j, w = nearest(R, t, tgt, tv)
            R2, t2 = rigid_fit(src, _rows(tgt, j), w, prec)
            ok = w.sum(-1) >= 3
            R = torch.where(ok[:, None, None], R2, R)
            t = torch.where(ok[:, None], t2, t)
        return R, t

    R = R0.transpose(-1, -2)
    t = -prec.mm(R, t0[..., None])[..., 0]
    n_fine = max_iter if coarse_stride <= 1 else min(fine_iters, max_iter)
    if max_iter - n_fine > 0:
        R, t = iterate(R, t, cad["xyz"][:, ::coarse_stride],
                       cad["valid"][:, ::coarse_stride], max_iter - n_fine)
    R, t = iterate(R, t, cad["xyz"], cad["valid"], n_fine)
    dmin, _, w = nearest(R, t, cad["xyz"], cad["valid"])
    dmin = torch.where(w > 0, dmin, torch.zeros_like(dmin))
    rmse = torch.sqrt((dmin * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0))
    Rt = R.transpose(-1, -2)
    return {"R": Rt, "t": -prec.mm(Rt, t[..., None])[..., 0], "rmse": rmse}


def rmse_at(cad, pc, R, t, max_corr, prec: Prec):
    """The rmse of the gated nearest distances of the cloud moved by the
    inverse of the model-to-camera pose (R, t), at full resolution."""
    Ri = R.transpose(-1, -2)
    moved = prec.mm(pc["xyz"] - t[:, None, :], Ri.transpose(-1, -2))
    d2 = sqdist(moved, cad["xyz"], prec).masked_fill(
        ~cad["valid"][:, None, :], math.inf)
    dmin = d2.min(-1).values
    w = (pc["valid"] & (dmin < (max_corr ** 2)[:, None])).to(dmin.dtype)
    dmin = torch.where(w > 0, dmin, torch.zeros_like(dmin))
    return torch.sqrt((dmin * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0))
