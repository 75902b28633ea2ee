"""Batched point-to-point ICP (port of pose6d_tpu/solvers/icp.py).

Each iteration pairs every transformed source point with its nearest
valid target point (the masked argmin kernel on the card) and takes a
distance-gated Kabsch update (the icp_kabsch_update op: one kernel on
the card, no host read). The iteration count is fixed: a Python loop
eagerly, one while_loop node under torch.export.
"""
from __future__ import annotations

import torch

from ..ops.kernels.icp import icp_kabsch_update
from ..ops.loops import run_while
from ..ops.nn import nearest_valid
from ..utils.profiling import count, counting, span, spanned


@spanned("icp")
def icp_point2point(src, src_valid, tgt, tgt_valid, R0, t0, max_corr_dist,
                    max_iter: int = 50, coarse_stride: int = 1,
                    fine_iters: int = 5):
    """Refine (R0, t0) aligning src (B, N, 3) onto tgt (B, M, 3).

    max_corr_dist (B,) or scalar. coarse_stride > 1 matches all but the
    last fine_iters iterations against every coarse_stride-th target
    point; the final iterations and the reported rmse / n_corr run at
    full resolution. Returns dict R (B, 3, 3), t (B, 3), rmse (B,),
    n_corr (B,).
    """
    src = src.float().contiguous()
    src_valid = src_valid.contiguous()
    tgt = tgt.float()
    bsz = src.shape[0]
    gate = (torch.as_tensor(max_corr_dist, dtype=torch.float32,
                            device=src.device).expand(bsz) ** 2).contiguous()

    def nn_pairs(R, t, tg, tv):
        moved = src @ R.transpose(-1, -2) + t[:, None, :]
        dmin, j = nearest_valid(moved, tg, tv)
        return j, dmin

    def iterate(R, t, tg, tv, n: int):
        """n iterations against (tg, tv): a fixed-count loop
        (ops/loops.run_while, a while_loop under torch.export)."""
        def step(i, R, t):
            with span("icp.match"):
                j, dmin = nn_pairs(R, t, tg, tv)
            with span("icp.update"):
                R, t, applied = icp_kabsch_update(src, src_valid, tg, j, dmin,
                                                  gate, R, t)
            if counting():
                count("icp.frame_updates", bsz)
                count("icp.applied_updates", applied)
            return i + 1, R, t

        _, R, t = run_while(lambda i, R, t: i < n, step,
                            (torch.zeros((), dtype=torch.int64,
                                         device=src.device), R, t), steps=n)
        return R, t

    # contiguous, as every iteration's output is
    R, t = R0.float().contiguous(), t0.float().contiguous()
    n_fine = max_iter if coarse_stride <= 1 else min(fine_iters, max_iter)
    n_coarse = max_iter - n_fine
    if n_coarse > 0:
        R, t = iterate(R, t, tgt[:, ::coarse_stride].contiguous(),
                       tgt_valid[:, ::coarse_stride].contiguous(), n_coarse)
    if n_fine > 0:
        R, t = iterate(R, t, tgt.contiguous(), tgt_valid, n_fine)
    with span("icp.match"):
        _, dmin = nn_pairs(R, t, tgt, tgt_valid)
        w = (src_valid & (dmin < gate[:, None])).float()
    n_corr = w.sum(-1)
    rmse = torch.sqrt((dmin * w).sum(-1) / torch.clamp(n_corr, min=1.0))
    return {"R": R, "t": t, "rmse": rmse, "n_corr": n_corr}


def icp_cloud_to_model(cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0,
                       max_corr_dist, max_iter: int = 50,
                       coarse_stride: int = 1, fine_iters: int = 5):
    """Partial-view refinement: match the OBSERVED cloud onto the CAD
    (bias-free for partial views), then invert back to a model->camera
    pose. Shapes as icp_point2point with src = pc, tgt = cad."""
    R0 = R0.float()
    t0 = t0.float()
    Rinv = R0.transpose(-1, -2)
    out = icp_point2point(pc_xyz, pc_valid, cad_xyz, cad_valid, Rinv,
                          -(Rinv @ t0[..., None])[..., 0],
                          max_corr_dist=max_corr_dist, max_iter=max_iter,
                          coarse_stride=coarse_stride, fine_iters=fine_iters)
    Rm, tm = out["R"], out["t"]
    Rt = Rm.transpose(-1, -2)
    return {"R": Rt, "t": -(Rt @ tm[..., None])[..., 0], "rmse": out["rmse"],
            "n_corr": out["n_corr"]}
