"""Candidate-map pose selection, base candidate only (port of
candidate_select_pose from pose6d_tpu/solvers/candidates.py).

The JAX function solves each candidate functional map (the base map,
rotation-TTA and ZoomOut maps) to a RANSAC pose, ranks the candidates
by depth consistency and refines the winner by ICP. With only the base
candidate the winner is always 0 and its score decides nothing, so this
port runs filter -> RANSAC -> ICP on the base map.
"""
from __future__ import annotations

import torch

from .fmap2pointmap import spatial_filtering_fmap2pointmap
from .icp import icp_cloud_to_model
from .ransac import ransac_pose

HYP_BLOCK = 512   # RANSAC hypotheses drawn and scored together
_CANDIDATES = ("rotation TTA and ZoomOut candidates are not ported yet: "
               "ROADMAP.md, modules still to port, item 9 (evaluation and "
               "the pose stage)")


def check_base_only(tta_rotations: int, zoomout_k: int) -> None:
    """Raises for the candidate options that the port does not run."""
    if tta_rotations > 1 or zoomout_k:
        raise NotImplementedError(_CANDIDATES)


def candidate_select_pose(model, cad, pc, diam, *, n_fmap: int,
                          tta_rotations: int = 0, zoomout_k: int = 0,
                          ransac_hypotheses: int = 4096, icp_iters: int = 30,
                          icp_coarse_stride: int = 4, generator=None,
                          uniforms=None) -> dict:
    """model: (cad, pc) -> model outputs; cad / pc dicts of (B, ...)
    padded tensors, diam (B,). RANSAC draws come from `generator` or
    `uniforms` (B, n_blocks, HYP_BLOCK, 3). Returns R, t, n_inliers,
    overlap12, overlap21, C, icp_rmse and candidate (B,), all 0."""
    check_base_only(tta_rotations, zoomout_k)
    with torch.inference_mode():
        out = model(cad, pc)
        pairs, pvalid = spatial_filtering_fmap2pointmap(
            out["C"], cad["evecs"][..., :n_fmap], pc["evecs"][..., :n_fmap],
            cad["xyz"], pc["xyz"], cad["valid"], pc["valid"], diam)
        src = torch.gather(cad["xyz"], 1,
                           pairs[:, 0, :, None].long().expand(-1, -1, 3))
        dst = torch.gather(pc["xyz"], 1,
                           pairs[:, 1, :, None].long().expand(-1, -1, 3))
        pose = ransac_pose(src, dst, pvalid, threshold=0.05 * diam,
                           n_hypotheses=ransac_hypotheses,
                           hyp_block=HYP_BLOCK, generator=generator,
                           uniforms=uniforms)
        icp = icp_cloud_to_model(cad["xyz"], cad["valid"], pc["xyz"],
                                 pc["valid"], pose["R"], pose["t"],
                                 max_corr_dist=0.2 * diam,
                                 max_iter=icp_iters,
                                 coarse_stride=icp_coarse_stride)
    return {"R": icp["R"], "t": icp["t"], "n_inliers": pose["n_inliers"],
            "n_trials": pose["n_trials"], "overlap12": out["overlap12"],
            "overlap21": out["overlap21"], "C": out["C"],
            "icp_rmse": icp["rmse"],
            "candidate": torch.zeros_like(pose["n_inliers"])}
