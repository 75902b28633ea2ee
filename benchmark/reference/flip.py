"""Plain depth-render flip disambiguation, the pose path's fifth stage
as the cell's traffic states it: a bank of model-frame rotations about
the CAD's centroid composed with the base pose, each hypothesis refined
by a short cloud-to-model ICP, every refined hypothesis rendered as a
coarse z-buffer of the posed CAD points and scored against the observed
depth image, the base hypothesis kept unless another scores clearly
lower, and the winner refined further. Written from this description: it imports
nothing of the program. Batched over a leading B; every product in the
reference's precision.

- Hypotheses: R_h = R0 S_h, t_h = t0 + R0 mu - R_h mu, with S_h the
  frame's bank (S_0 the identity) and mu the mean of the valid CAD
  points.
- Bank ICP: pose.icp from each hypothesis, `bank_iters` iterations, the
  last one at full resolution, the rest against every
  coarse_stride-th CAD point.
- Render: each valid CAD point with camera depth z > 1e-3 lands in cell
  (int(v), int(u)) of a (H // stride, W // stride) grid, u = (fx x / z +
  cx) / stride and v = (fy y / z + cy) / stride, each truncated toward
  zero and clipped to the grid (the point kept only where 0 <= u < W /
  stride and 0 <= v < H / stride); a cell keeps its least depth.
- Observed cells: the least positive depth of each stride x stride
  block's masked pixels.
- Score: the mean |rendered - observed| over cells that have both, plus
  half the diameter times the share of rendered cells with no
  observation and half the diameter times the share of observed cells
  left unrendered. Hypotheses but the first are handicapped by (1 +
  margin); the first least handicapped score wins.
- Refine: pose.icp from the winner, icp_iters - bank_iters iterations,
  the last five at full resolution; its rmse is the stage's.
"""
from __future__ import annotations

import torch

from . import pose as ref_pose
from .precision import Prec

BIG = 1e9


def hypotheses(cad, R0, t0, bank, prec: Prec):
    """(B, H, 3, 3) rotations and (B, H, 3) translations of the bank
    (B, H, 3, 3) about each CAD's valid centroid."""
    w = cad["valid"].to(cad["xyz"].dtype)[..., None]
    mu = (cad["xyz"] * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    Rs = prec.mm(R0[:, None], bank)
    ts = (t0[:, None] + prec.mm(R0, mu[..., None])[..., 0][:, None]
          - prec.mm(Rs, mu[:, None, :, None])[..., 0])
    return Rs, ts


def render(xyz, valid, R, t, K, h: int, w: int, stride: int, prec: Prec):
    """Coarse z-buffers (N, h // stride, w // stride) of points xyz (N,
    V, 3) posed by R (N, 3, 3), t (N, 3) through K (N, 3, 3); BIG where
    no point lands."""
    cam = prec.mm(xyz, R.transpose(-1, -2)) + t[:, None, :]
    z = cam[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = (K[:, 0, 0, None] * cam[..., 0] / zc + K[:, 0, 2, None]) / stride
    v = (K[:, 1, 1, None] * cam[..., 1] / zc + K[:, 1, 2, None]) / stride
    hh, ww = h // stride, w // stride
    ui = torch.clamp(torch.trunc(u), 0, ww - 1).long()
    vi = torch.clamp(torch.trunc(v), 0, hh - 1).long()
    ok = valid & (z > 1e-3) & (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
    cell = torch.where(ok, vi * ww + ui, hh * ww)
    zbuf = torch.full((xyz.shape[0], hh * ww + 1), BIG, dtype=z.dtype,
                      device=z.device)
    zbuf.scatter_reduce_(1, cell, torch.where(ok, z, BIG), "amin")
    return zbuf[:, :-1].reshape(-1, hh, ww)


def observed(depth, mask, stride: int):
    """(B, H // stride, W // stride): each block's least positive masked
    depth, BIG where it has none."""
    b, h, w = depth.shape
    hh, ww = h // stride, w // stride
    d = depth[:, :hh * stride, :ww * stride]
    m = mask[:, :hh * stride, :ww * stride] & (d > 0)
    d = torch.where(m, d, torch.full_like(d, BIG))
    return d.reshape(b, hh, stride, ww, stride).amin(dim=(2, 4))


def score(rendered, obs, diam):
    """Depth-consistency scores of renders (B, H, hh, ww) against the
    observed cells (B, hh, ww); lower is better."""
    obs = obs[:, None]
    has_o, has_r = obs < BIG / 2, rendered < BIG / 2
    both = has_o & has_r

    def n(m):
        return m.sum((-2, -1)).to(rendered.dtype)

    err = (torch.where(both, (rendered - obs).abs(), 0.0).sum((-2, -1))
           / torch.clamp(n(both), min=1.0))
    spill = n(has_r & ~has_o) / torch.clamp(n(has_r), min=1.0)
    unexplained = n(has_o & ~has_r) / torch.clamp(n(has_o), min=1.0)
    half = 0.5 * diam[:, None]
    return err + half * spill + half * unexplained


def flip_stage(cad, pc, R0, t0, diam, K, depth, mask, bank, recipe: dict,
               prec: Prec) -> dict:
    """The stage from the base pose (R0, t0): cad / pc dicts of (B, ...)
    tensors (xyz, valid), diam (B,), K (B, 3, 3), depth (B, H, W) in the
    CAD's units, mask (B, H, W), bank (B, H, 3, 3). recipe: icp_iters,
    bank_iters, coarse_stride, render_stride, margin, gate (x diameter).
    Returns R, t, rmse, hypothesis, scores."""
    bsz, n_hyp = bank.shape[:2]
    Rs, ts = hypotheses(cad, R0, t0, bank, prec)

    def rep(d):
        return {k: v.repeat_interleave(n_hyp, 0) for k, v in d.items()}

    gate = recipe["gate"] * diam
    bank_iters = min(recipe["bank_iters"], recipe["icp_iters"])
    hyp = ref_pose.icp(rep(cad), rep(pc), Rs.reshape(-1, 3, 3),
                       ts.reshape(-1, 3), gate.repeat_interleave(n_hyp),
                       bank_iters, recipe["coarse_stride"], prec,
                       fine_iters=1)
    h, w = depth.shape[-2:]
    s = recipe["render_stride"]
    cads = rep(cad)
    rendered = render(cads["xyz"], cads["valid"], hyp["R"], hyp["t"],
                      K.repeat_interleave(n_hyp, 0), h, w, s, prec)
    scores = score(rendered.reshape(bsz, n_hyp, *rendered.shape[1:]),
                   observed(depth, mask, s), diam)
    handicap = torch.full((n_hyp,), 1.0 + recipe["margin"],
                          dtype=scores.dtype, device=scores.device)
    handicap[0] = 1.0
    best = torch.argmin(scores * handicap, dim=-1)
    ar = torch.arange(bsz, device=best.device)
    R = hyp["R"].reshape(bsz, n_hyp, 3, 3)[ar, best]
    t = hyp["t"].reshape(bsz, n_hyp, 3)[ar, best]
    rmse = hyp["rmse"].reshape(bsz, n_hyp)[ar, best]
    more = recipe["icp_iters"] - bank_iters
    if more > 0:
        fin = ref_pose.icp(cad, pc, R, t, gate, more, recipe["coarse_stride"],
                           prec, fine_iters=5)
        R, t, rmse = fin["R"], fin["t"], fin["rmse"]
    return {"R": R, "t": t, "rmse": rmse, "hypothesis": best,
            "scores": scores}
