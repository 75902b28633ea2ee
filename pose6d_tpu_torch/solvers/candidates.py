"""Candidate functional maps and evidence-based pose selection (port of
pose6d_tpu/solvers/candidates.py, batched over a leading B).

The measured unseen-object failure is a globally consistent but rotated
functional map: the spatial filter cannot reject it and the flip bank
cannot rescue it. Rotation TTA re-runs the model on coarsely rotated
copies of the observed cloud (so3_bank) and ZoomOut upsamples the map in
the cached spectral basis; every candidate map is solved to a RANSAC
pose on the same draws and ranked by depth-render consistency
(solvers/verify_pose.py). A weak-base trigger keeps strong base maps
unconditionally, and the non-base candidates carry a score handicap
(select_margin), so near-ties resolve to the base path. The winner is
refined by ICP against the observed cloud.
"""
from __future__ import annotations

import torch

from ..utils.profiling import spanned
from .fmap2pointmap import spatial_filtering_fmap2pointmap
from .icp import icp_cloud_to_model
from .multistart import so3_bank
from .ransac import ransac_pose
from .verify_pose import depth_consistency_score
from .zoomout import zoomout_refine

HYP_BLOCK = 512        # RANSAC hypotheses drawn and scored together
ZOOMOUT_GATE_TAU = 0.15


def rotate_about_centroid(xyz, valid, R3):
    """Rotate each cloud (B, V, 3) by R3 (3, 3) about its valid-point
    centroid; padded rows stay zero. A rigid motion keeps every cached
    spectral quantity valid."""
    vf = valid.to(xyz.dtype)[..., None]
    c = (xyz * vf).sum(-2, keepdim=True) / torch.clamp(
        vf.sum(-2, keepdim=True), min=1.0)
    R3 = torch.as_tensor(R3, dtype=xyz.dtype, device=xyz.device)
    return torch.where(vf > 0, (xyz - c) @ R3.T + c, 0.0)


def candidate_maps(model, cad, pc, diam, n_fmap: int,
                   tta_rotations: int = 0, zoomout_k: int = 0,
                   zoomout_step: int = 4,
                   gate_tau: float = ZOOMOUT_GATE_TAU,
                   refine_rotations: bool = False) -> list:
    """[(model outputs, C (B, k, k), k, pc_xyz), ...]: the base candidate
    first, then its ZoomOut upsampling (zoomout_k > 0, gated at gate_tau
    of the diameter), then the map of each non-identity rotation of
    so3_bank(tta_rotations) (tta_rotations > 1), followed by its own
    upsampling when refine_rotations (the evaluation's candidates).
    pc_xyz is the cloud the map was predicted from (rotated or not)."""
    def maps(pc_r, refine: bool) -> list:
        out = model(cad, pc_r)
        cands = [(out, out["C"], n_fmap, pc_r["xyz"])]
        if zoomout_k and refine:
            C_r = zoomout_refine(out["C"], cad["evecs"][..., :zoomout_k],
                                 pc_r["evecs"][..., :zoomout_k],
                                 cad["valid"], pc_r["valid"],
                                 step=zoomout_step, cad_xyz=cad["xyz"],
                                 pc_xyz=pc_r["xyz"], diam=diam,
                                 gate_tau=gate_tau)
            cands.append((out, C_r, zoomout_k, pc_r["xyz"]))
        return cands

    cands = maps(pc, True)
    if tta_rotations > 1:
        for R3 in so3_bank(tta_rotations)[1:]:     # [0] is the identity
            xyz_r = rotate_about_centroid(pc["xyz"], pc["valid"], R3)
            cands += maps({**pc, "xyz": xyz_r}, refine_rotations)
    return cands


def select_candidate(scores, base_surv, n_valid, select_trigger: float):
    """Winner per sample over handicapped scores (n_candidates, B), lower
    wins, ties to the lower index (the base map first). Samples whose
    base map is strong (base_surv >= select_trigger * n_valid spatial-
    filter survivors) keep the base map (0)."""
    engaged = base_surv < select_trigger * n_valid
    return torch.where(engaged, torch.argmin(scores, 0), 0)


def _gather_rows(xyz, idx):
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))


@spanned("pose")
def candidate_select_pose(model, cad, pc, diam, *, n_fmap: int,
                          tta_rotations: int = 0, zoomout_k: int = 0,
                          ransac_hypotheses: int = 4096, icp_iters: int = 30,
                          icp_coarse_stride: int = 4,
                          select_margin: float = 0.15,
                          select_trigger: float = 0.25, K=None, obs_z=None,
                          mask=None, generator=None, uniforms=None) -> dict:
    """Candidate maps -> spatial filter and RANSAC per candidate ->
    depth-render score -> winner -> ICP against the observed cloud.

    model: (cad, pc) -> model outputs; cad / pc dicts of (B, ...) padded
    tensors, diam (B,). With more than the base candidate, K (B, 3, 3),
    obs_z (B, H, W) observed depth in cm and mask (B, H, W) are the
    scoring evidence. RANSAC draws come from `generator` (every
    candidate from the same generator state) or `uniforms` (B, n_blocks,
    HYP_BLOCK, 3). Returns R, t, n_inliers, n_trials (the winner's),
    overlap12, overlap21, C (the base map's), icp_rmse and candidate
    (B,), the winner (0: the base map)."""
    with torch.inference_mode():
        cands = candidate_maps(model, cad, pc, diam, n_fmap=n_fmap,
                               tta_rotations=tta_rotations,
                               zoomout_k=zoomout_k)
        out = cands[0][0]
        if len(cands) > 1 and K is None:
            raise ValueError("candidate selection needs K, obs_z and mask")
        bsz = cad["xyz"].shape[0]
        ar = torch.arange(bsz, device=cad["xyz"].device)
        diam = torch.as_tensor(diam, dtype=torch.float32,
                               device=ar.device).expand(bsz)
        state = None if generator is None else generator.get_state()
        poses, scores = [], []
        for ci, (_, C, k, _) in enumerate(cands):
            pairs, pvalid = spatial_filtering_fmap2pointmap(
                C, cad["evecs"][..., :k], pc["evecs"][..., :k], cad["xyz"],
                pc["xyz"], cad["valid"], pc["valid"], diam)
            if ci == 0:
                base_surv = pvalid.sum(-1)
            if state is not None:
                generator.set_state(state)
            pose = ransac_pose(_gather_rows(cad["xyz"], pairs[:, 0]),
                               _gather_rows(pc["xyz"], pairs[:, 1]), pvalid,
                               threshold=0.05 * diam,
                               n_hypotheses=ransac_hypotheses,
                               hyp_block=HYP_BLOCK, generator=generator,
                               uniforms=uniforms)
            poses.append(pose)
            if len(cands) > 1:
                s = depth_consistency_score(cad["xyz"], cad["valid"],
                                            pose["R"], pose["t"], K, obs_z,
                                            mask, diam)
                scores.append(s * (1.0 + select_margin if ci else 1.0))
        if len(cands) > 1:
            winner = select_candidate(torch.stack(scores), base_surv,
                                      pc["valid"].sum(-1), select_trigger)
        else:
            winner = torch.zeros(bsz, dtype=torch.int64, device=ar.device)

        def pick(key):
            return torch.stack([p[key] for p in poses], 1)[ar, winner]

        icp = icp_cloud_to_model(cad["xyz"], cad["valid"], pc["xyz"],
                                 pc["valid"], pick("R"), pick("t"),
                                 max_corr_dist=0.2 * diam,
                                 max_iter=icp_iters,
                                 coarse_stride=icp_coarse_stride)
    return {"R": icp["R"], "t": icp["t"], "n_inliers": pick("n_inliers"),
            "n_trials": pick("n_trials"), "overlap12": out["overlap12"],
            "overlap21": out["overlap21"], "C": out["C"],
            "icp_rmse": icp["rmse"], "candidate": winner}
