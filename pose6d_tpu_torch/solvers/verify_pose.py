"""Render-and-compare pose verification (port of
pose6d_tpu/solvers/verify_pose.py).

A pose is scored against the observed depth image: the posed CAD
vertices are splatted into a coarse z-buffer (scatter-min) and compared
with the observed depth cells, (a) by the mean |rendered z - observed z|
where both exist, plus (b) the share of rendered cells outside the
observation and (c) the share of observed cells left unexplained, both
weighted by half the diameter. Lower is better.

Leading dimensions broadcast: cad (B, 1, V, 3) against R (B, H, 3, 3)
scores H hypotheses of each of B frames against that frame's depth.
"""
from __future__ import annotations

import torch

BIGZ = 1e9


def splat_depth(cad_xyz, cad_valid, R, t, K, h: int, w: int,
                stride: int = 4):
    """Posed CAD -> coarse z-buffer (..., h // stride, w // stride), cm.

    cad_xyz (..., V, 3), cad_valid (..., V), R (..., 3, 3), t (..., 3),
    K (..., 3, 3); leading dimensions broadcast."""
    cam = cad_xyz @ R.transpose(-1, -2) + t[..., None, :]
    z = cam[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = (K[..., 0, 0, None] * cam[..., 0] / zc + K[..., 0, 2, None]) / stride
    v = (K[..., 1, 1, None] * cam[..., 1] / zc + K[..., 1, 2, None]) / stride
    hh, ww = h // stride, w // stride
    # int32 truncates toward zero, as astype(int32) does, before the clip
    ui = torch.clamp(u.to(torch.int32), 0, ww - 1)
    vi = torch.clamp(v.to(torch.int32), 0, hh - 1)
    ok = cad_valid & (z > 1e-3) & (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
    lead = ok.shape[:-1]
    flat = torch.where(ok, vi * ww + ui, hh * ww).long().reshape(-1,
                                                                 ok.shape[-1])
    zs = torch.where(ok, z, BIGZ).reshape(flat.shape)
    zbuf = torch.full((flat.shape[0], hh * ww + 1), BIGZ,
                      dtype=torch.float32, device=z.device)
    zbuf.scatter_reduce_(1, flat, zs, "amin", include_self=True)
    return zbuf[:, :-1].reshape(*lead, hh, ww)


def observed_cells(observed_z, mask, hh: int, ww: int, stride: int = 4):
    """Coarse observed depth (..., hh, ww): the nearest valid masked pixel
    of each stride x stride cell (0-depth holes carry no evidence), BIGZ
    where the cell has none."""
    obs = observed_z[..., :hh * stride, :ww * stride]
    msk = mask[..., :hh * stride, :ww * stride]
    lead = obs.shape[:-2]
    cell = torch.where(msk & (obs > 0), obs, BIGZ).reshape(
        *lead, hh, stride, ww, stride)
    return torch.amin(cell, dim=(-3, -1))


def depth_consistency_score(cad_xyz, cad_valid, R, t, K, observed_z, mask,
                            diam, stride: int = 4):
    """Lower-is-better score of poses against observed depth.

    observed_z (..., H, W) in the CAD's units (cm), 0 where invalid;
    mask (..., H, W) the instance mask; diam (...). Shapes as
    splat_depth; returns the broadcast leading shape."""
    h, w = observed_z.shape[-2:]
    rendered = splat_depth(cad_xyz, cad_valid, R, t, K, h, w, stride)
    hh, ww = rendered.shape[-2:]
    obs_cell = observed_cells(observed_z.float(), mask, hh, ww, stride)
    has_obs = obs_cell < BIGZ * 0.5
    has_ren = rendered < BIGZ * 0.5
    both = has_obs & has_ren
    dims = (-2, -1)
    n_both = torch.clamp(both.sum(dims).float(), min=1.0)
    depth_err = torch.sum(torch.where(both, torch.abs(rendered - obs_cell),
                                      0.0), dim=dims) / n_both
    n_ren = torch.clamp(has_ren.sum(dims).float(), min=1.0)
    spill = (has_ren & ~has_obs).sum(dims).float() / n_ren
    n_obs = torch.clamp(has_obs.sum(dims).float(), min=1.0)
    uncovered = (has_obs & ~has_ren).sum(dims).float() / n_obs
    return depth_err + 0.5 * diam * spill + 0.5 * diam * uncovered
