"""Per-frame prediction API (port of pose6d_tpu/api.py).

    model = load_flax_checkpoint("weights/synth_seen.msgpack", DPFMNet())
    pred = Predictor(model, cad_bank={5: cad_ops})        # runs on cuda
    results = pred.predict(depth, K, depth_scale, masks=[mask0],
                           obj_ids=[5])
    # -> [{"R": (3, 3), "t": (3,), "flip_hypothesis": ..., ...}]

cad_ops are host dicts {xyz, mass, evals, evecs} as
spectral.operators.point_cloud_operators returns them. predict() is the
online mode: per instance, the depth frame is backprojected, cleaned of
outliers and farthest-point sampled, its spectral operators are computed
on the device (graph Laplacian and LOBPCG), and DPFMNet -> spatial
filter -> RANSAC -> cloud-to-model ICP -> depth-consistency flip
disambiguation give the pose. One instance is one call of _frame, the
function that serving.export_predictor also traces into its artifact.
predict_with_operators() is the cached mode: the partial cloud's
operators come precomputed from the host, and the pose is not
disambiguated (there is no depth image). The batched entries:
pose_from_operators (the cached mode's pipeline) and
pose_from_depth_operators (the same, then the flip stage against each
frame's depth image; the online request's path after its cloud stage).
"""
from __future__ import annotations

import numpy as np
import torch

from .models import DPFMNet
from .ops import geometry, sampling
from .ops.masking import V_CAD, V_PC, pad_to
from .ops.symmetry import disambiguation_bank
from .runtime import resolve_device
from .solvers.candidates import HYP_BLOCK, candidate_select_pose
from .solvers.multistart import disambiguate_pose_depth
from .spectral import device_lbo

MAX_RAW = 16384   # backprojected points kept per instance
_NO_GRAD = ("a gradient-feature model (with_gradient_features) needs the "
            "partial cloud's tangent-gradient operators, which serving does "
            "not build (the JAX package's pad_cad_operators carries none "
            "either)")
# pose_from_depth_operators' outputs that a Predictor does not return
_BATCH_ONLY = ("R0", "t0", "flip_score", "flip_rmse")


def pad_operators(ops: dict, v: int, device) -> dict:
    """Host operators (CAD or PC) -> padded tensors on `device` with a
    validity mask (pad_cad_operators in the JAX package)."""
    n = len(ops["xyz"])
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                     device=device)
    return {"xyz": as_t(pad_to(ops["xyz"], v)),
            "mass": as_t(pad_to(ops["mass"], v)),
            "evals": as_t(ops["evals"]),
            "evecs": as_t(pad_to(ops["evecs"], v)),
            "valid": torch.arange(v, device=device) < n}


def pose_from_operators(model: DPFMNet, cad: dict, pc: dict, diam,
                        n_hypotheses: int = 131072, icp_iters: int = 30,
                        coarse_stride: int = 1, generator=None,
                        uniforms=None) -> dict:
    """DPFMNet -> spatial filter -> RANSAC -> ICP on a batch: cad/pc
    dicts of (B, ...) padded tensors, diam (B,) CAD diameters. The
    cached mode's whole pipeline, and the online mode's before the flip
    stage."""
    out = candidate_select_pose(model, cad, pc, diam, n_fmap=model.cfg.n_fmap,
                                ransac_hypotheses=n_hypotheses,
                                icp_iters=icp_iters,
                                icp_coarse_stride=coarse_stride,
                                generator=generator, uniforms=uniforms)
    del out["candidate"]
    return out


def pose_from_depth_operators(model: DPFMNet, cad: dict, pc: dict, diam, K,
                              obs_z, mask, sym_rots,
                              n_hypotheses: int = 131072,
                              icp_iters: int = 30, coarse_stride: int = 1,
                              generator=None, uniforms=None) -> dict:
    """pose_from_operators, then depth-render flip disambiguation
    (solvers/multistart.disambiguate_pose_depth at its defaults) on a
    batch: K (B, 3, 3), obs_z (B, H, W) observed depth in cm (0 where
    invalid), mask (B, H, W), sym_rots (B, n, 3, 3) each frame's flip
    bank (ops/symmetry.disambiguation_bank of its CAD, built on the
    host). Returns pose_from_operators' keys with R, t the flipped and
    refined pose, and R0, t0 the base ICP pose (icp_rmse stays its
    rmse), flip_hypothesis, flip_score and flip_rmse (the full-resolution
    rmse of the final refine)."""
    out = pose_from_operators(model, cad, pc, diam, n_hypotheses=n_hypotheses,
                              icp_iters=icp_iters,
                              coarse_stride=coarse_stride,
                              generator=generator, uniforms=uniforms)
    fix = disambiguate_pose_depth(cad["xyz"], cad["valid"], pc["xyz"],
                                  pc["valid"], out["R"], out["t"], diam, K,
                                  obs_z, mask, sym_rots=sym_rots)
    out.update(R=fix["R"], t=fix["t"], R0=out["R"], t0=out["t"],
               flip_hypothesis=fix["hypothesis"], flip_score=fix["score"],
               flip_rmse=fix["rmse"])
    return out


class Predictor:
    def __init__(self, model: DPFMNet, cad_bank: dict, mode: str = "online",
                 v_cad: int = V_CAD, v_pc: int = V_PC, max_pc: int = 2000,
                 ransac_hypotheses: int = 131072, icp_iters: int = 30,
                 lobpcg_iters: int = 80, disambiguate: bool = True,
                 fps_groups: int = 1, tta_rotations: int = 0,
                 zoomout_k: int = 0, select_margin: float = 0.15,
                 select_trigger: float = 0.25, device="cuda"):
        """model: a DPFMNet with its weights loaded; cad_bank: {obj_id:
        host operators}. Runs on `device` (default cuda; raises when
        CUDA is missing unless device="cpu" is asked for).

        disambiguate (default on): the depth-consistency flip stage
        after ICP in predict(), with each object's detected-symmetry
        bank (ops/symmetry.disambiguation_bank, built here on the host
        in online mode).
        tta_rotations > 1 / zoomout_k > 0 (default off): candidate maps
        in predict() (solvers/candidates.py): forwards of rigidly rotated
        clouds and / or a ZoomOut upsampling of the predicted map, each
        solved to a RANSAC pose and scored by depth-render consistency,
        the base map protected by the select_margin handicap and the
        select_trigger weak-base gate. predict_with_operators stays
        base-only (it has no depth image). fps_groups > 1: grouped FPS
        (ops/sampling.farthest_point_sample_grouped) when max_pc and
        MAX_RAW divide by it, otherwise exact FPS, as the JAX package
        chooses: the online path's 2000-step dependent chain becomes one
        of 2000 / fps_groups steps over fps_groups strata, at the cost of
        a covering radius up to ~1.35x the exact one. A gradient-feature
        model raises ValueError: serving builds no tangent-gradient
        operators."""
        if model.cfg.with_gradient_features:
            raise ValueError(_NO_GRAD)
        self.device = resolve_device(device)
        if mode not in ("online", "cached"):
            raise ValueError(f"mode must be 'online' or 'cached': {mode}")
        self.mode = mode
        self.model = model.to(self.device).eval()
        self.v_pc = v_pc
        self.max_pc = max_pc
        self.disambiguate = disambiguate
        self.cad_bank = {int(k): pad_operators(v, v_cad, self.device)
                         for k, v in cad_bank.items()}
        self._diam = {int(k): float(np.linalg.norm(
            np.asarray(v["xyz"]).max(0) - np.asarray(v["xyz"]).min(0)))
            for k, v in cad_bank.items()}
        # the online mode's flip banks; the cached mode has no depth image
        # to rank flips against
        self._sym_rots = {int(k): torch.as_tensor(
            disambiguation_bank(np.asarray(v["xyz"]), max_rots=6),
            device=self.device) for k, v in cad_bank.items()
            if mode == "online" and disambiguate}
        self._rh = ransac_hypotheses
        self._icp_iters = icp_iters
        self._lobpcg_iters = lobpcg_iters
        self._tta = tta_rotations
        self._zk = zoomout_k
        self._sel_margin = select_margin
        self._sel_trigger = select_trigger
        self._fps_groups = fps_groups
        # LOBPCG's start block, drawn once (device_lbo.default_x0)
        self._x0 = (device_lbo.default_x0(v_pc, model.cfg.k_eig, self.device)
                    if mode == "online" else None)

    # -- stages -------------------------------------------------------------
    def _cloud_from_depth(self, depth, K, cam_scale, mask):
        """(1, H, W) depth and mask on the device -> the sampled partial
        cloud (1, v_pc, 3) and its valid mask, padded."""
        pts, valid = geometry.backproject_depth(depth, K, cam_scale, mask,
                                                max_points=MAX_RAW)
        keep = geometry.statistical_outlier_mask(pts, valid)
        g = self._fps_groups
        if g > 1 and self.max_pc % g == 0 and MAX_RAW % g == 0:
            idx, sel_valid = sampling.farthest_point_sample_grouped(
                pts, keep, self.max_pc, groups=g)
        else:
            idx, sel_valid = sampling.farthest_point_sample(pts, keep,
                                                            self.max_pc)
        pc = torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))
        pc = torch.where(sel_valid[..., None], pc, 0.0)
        pad = self.v_pc - self.max_pc
        return (torch.nn.functional.pad(pc, (0, 0, 0, pad))[:, :self.v_pc],
                torch.nn.functional.pad(sel_valid, (0, pad))[:, :self.v_pc])

    def _operators(self, pc_xyz, pc_valid, x0=None) -> dict:
        mass, evals, evecs = device_lbo.device_pc_operators(
            pc_xyz, pc_valid, k_eig=self.model.cfg.k_eig,
            iters=self._lobpcg_iters, x0=x0)
        return {"xyz": pc_xyz, "mass": mass, "evals": evals,
                "evecs": evecs, "valid": pc_valid}

    def _object(self, obj: int) -> dict:
        """What a frame of object `obj` reads besides its inputs: the
        padded CAD operators (1, ...), the diameter (1,), the flip bank
        (1, H, 3, 3) when disambiguating, and LOBPCG's start block."""
        state = {"cad": {k: v[None] for k, v in self.cad_bank[obj].items()},
                 "diam": torch.tensor([self._diam[obj]], dtype=torch.float32,
                                      device=self.device),
                 "x0": self._x0}
        if self.disambiguate:
            state["sym_rots"] = self._sym_rots[obj][None]
        return state

    def _pose_from_cloud(self, state: dict, pc: dict, K, obs_z, mask,
                         generator=None, uniforms=None) -> dict:
        cad, diam = state["cad"], state["diam"]
        if not (self._tta > 1 or self._zk):
            if not self.disambiguate:
                return pose_from_operators(
                    self.model, cad, pc, diam, n_hypotheses=self._rh,
                    icp_iters=self._icp_iters, generator=generator,
                    uniforms=uniforms)
            out = pose_from_depth_operators(
                self.model, cad, pc, diam, K, obs_z, mask, state["sym_rots"],
                n_hypotheses=self._rh, icp_iters=self._icp_iters,
                generator=generator, uniforms=uniforms)
            return {k: v for k, v in out.items() if k not in _BATCH_ONLY}
        out = candidate_select_pose(
            self.model, cad, pc, diam, n_fmap=self.model.cfg.n_fmap,
            tta_rotations=self._tta, zoomout_k=self._zk,
            ransac_hypotheses=self._rh, icp_iters=self._icp_iters,
            select_margin=self._sel_margin, select_trigger=self._sel_trigger,
            K=K, obs_z=obs_z, mask=mask, generator=generator,
            uniforms=uniforms)
        if self.disambiguate:
            fix = disambiguate_pose_depth(
                cad["xyz"], cad["valid"], pc["xyz"], pc["valid"], out["R"],
                out["t"], diam, K, obs_z, mask, sym_rots=state["sym_rots"])
            out.update(R=fix["R"], t=fix["t"],
                       flip_hypothesis=fix["hypothesis"])
        return out

    def _frame(self, state: dict, depth, K, cam_scale, mask, uniforms=None,
               generator=None) -> dict:
        """One instance of one depth frame, on the device: depth (H, W) f32
        raw BOP units, K (3, 3) f32, cam_scale () f32 (1000 /
        depth_scale), mask (H, W) bool; uniforms (n_blocks, HYP_BLOCK, 3)
        RANSAC draws in [0, 1), or None to draw from `generator`; state
        from _object. Returns the pose dict with a leading batch of 1
        (R, t, n_inliers, icp_rmse, overlap21, flip_hypothesis and the
        stage outputs beside them). The live request and the exported
        artifact both run this function."""
        depth, K, mask = depth[None], K[None], mask[None]
        pc_xyz, pc_valid = self._cloud_from_depth(depth, K, cam_scale, mask)
        pc = self._operators(pc_xyz, pc_valid, state["x0"])
        # observed depth in pipeline units (cm) for pose verification
        obs_z = depth * (100.0 / cam_scale)
        return self._pose_from_cloud(
            state, pc, K, obs_z, mask, generator=generator,
            uniforms=None if uniforms is None else uniforms[None])

    # -- public -------------------------------------------------------------
    def predict(self, depth, K, depth_scale, masks, obj_ids, seed: int = 0,
                uniforms=None) -> list:
        """One depth frame -> per-instance poses.

        depth (H, W) raw BOP depth; K (3, 3); depth_scale: BOP scale
        (depth_mm = depth * depth_scale); masks: list of (H, W) bool;
        obj_ids: the matching CAD ids of the cad_bank. uniforms,
        optional: per instance, RANSAC draws (n_blocks, HYP_BLOCK, 3) to
        use instead of the generator seeded with `seed`.
        """
        if self.mode != "online":
            raise ValueError("cached mode: use predict_with_operators")
        dev = self.device
        cam_scale = torch.tensor(1000.0 / depth_scale, dtype=torch.float32,
                                 device=dev)
        depth = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        results = []
        for i, (mask, obj_id) in enumerate(zip(masks, obj_ids)):
            m = torch.as_tensor(np.asarray(mask, bool), device=dev)
            u = None if uniforms is None else torch.as_tensor(
                uniforms[i], device=dev)
            with torch.inference_mode():
                out = self._frame(self._object(int(obj_id)), depth, K,
                                  cam_scale, m, u, generator=gen)
            results.append({k: v[0].cpu().numpy() for k, v in out.items()})
        return results

    def predict_with_operators(self, cad_obj_id: int, pc_ops: dict,
                               seed: int = 0, uniforms=None) -> dict:
        """Cached mode: partial-cloud operators precomputed on the host.
        uniforms (n_blocks, HYP_BLOCK, 3), optional: RANSAC draws to use
        instead of the seeded generator."""
        obj = int(cad_obj_id)
        cad = {k: v[None] for k, v in self.cad_bank[obj].items()}
        pc = {k: v[None] for k, v in
              pad_operators(pc_ops, self.v_pc, self.device).items()}
        diam = torch.tensor([self._diam[obj]], dtype=torch.float32,
                            device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if uniforms is not None:
            uniforms = torch.as_tensor(uniforms, device=self.device)[None]
        out = pose_from_operators(self.model, cad, pc, diam,
                                  n_hypotheses=self._rh,
                                  icp_iters=self._icp_iters,
                                  generator=gen, uniforms=uniforms)
        return {k: v[0].cpu().numpy() for k, v in out.items()}


__all__ = ["HYP_BLOCK", "MAX_RAW", "Predictor", "pad_operators",
           "pose_from_depth_operators", "pose_from_operators"]
