"""Per-frame prediction API, cached-operator mode (port of pose6d_tpu/api.py).

    model = load_flax_checkpoint("weights/synth_seen.msgpack", DPFMNet())
    pred = Predictor(model, cad_bank={5: cad_ops})        # runs on cuda
    out = pred.predict_with_operators(5, pc_ops, seed=0)
    # -> {"R": (3, 3), "t": (3,), "n_inliers": ..., "icp_rmse": ..., ...}

cad_ops / pc_ops are host dicts {xyz, mass, evals, evecs} as
spectral.operators.point_cloud_operators returns them. A request runs
DPFMNet -> spatial filter -> RANSAC -> cloud-to-model ICP. The online
mode (on-device preprocessing) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import DPFMNet
from .ops.masking import V_CAD, V_PC, pad_to
from .runtime import resolve_device
from .solvers import (icp_cloud_to_model, ransac_pose,
                      spatial_filtering_fmap2pointmap)

HYP_BLOCK = 512   # RANSAC hypotheses drawn and scored together
_ONLINE = ("online mode is not ported yet: ROADMAP.md, modules still to "
           "port, item 7 (online-mode preprocessing)")


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
    """The cached-mode pipeline on a batch: cad/pc dicts of (B, ...)
    padded tensors, diam (B,) CAD diameters."""
    nf = model.cfg.n_fmap
    with torch.inference_mode():
        out = model(cad, pc)
        pairs, pvalid = spatial_filtering_fmap2pointmap(
            out["C"], cad["evecs"][..., :nf], pc["evecs"][..., :nf],
            cad["xyz"], pc["xyz"], cad["valid"], pc["valid"], diam)
        src = torch.gather(cad["xyz"], 1,
                           pairs[:, 0, :, None].long().expand(-1, -1, 3))
        dst = torch.gather(pc["xyz"], 1,
                           pairs[:, 1, :, None].long().expand(-1, -1, 3))
        pose = ransac_pose(src, dst, pvalid, threshold=0.05 * diam,
                           n_hypotheses=n_hypotheses, hyp_block=HYP_BLOCK,
                           generator=generator, uniforms=uniforms)
        icp = icp_cloud_to_model(cad["xyz"], cad["valid"], pc["xyz"],
                                 pc["valid"], pose["R"], pose["t"],
                                 max_corr_dist=0.2 * diam,
                                 max_iter=icp_iters,
                                 coarse_stride=coarse_stride)
    return {"R": icp["R"], "t": icp["t"], "n_inliers": pose["n_inliers"],
            "n_trials": pose["n_trials"],
            "overlap12": out["overlap12"], "overlap21": out["overlap21"],
            "C": out["C"], "icp_rmse": icp["rmse"]}


class Predictor:
    def __init__(self, model: DPFMNet, cad_bank: dict, mode: str = "cached",
                 v_cad: int = V_CAD, v_pc: int = V_PC,
                 ransac_hypotheses: int = 131072, icp_iters: int = 30,
                 device="cuda"):
        """model: a DPFMNet with its weights loaded; cad_bank: {obj_id:
        host operators}. Runs on `device` (default cuda; raises when
        CUDA is missing unless device="cpu" is asked for)."""
        self.device = resolve_device(device)
        if mode != "cached":
            raise NotImplementedError(_ONLINE)
        self.model = model.to(self.device).eval()
        self.v_pc = v_pc
        self.cad_bank = {int(k): pad_operators(v, v_cad, self.device)
                         for k, v in cad_bank.items()}
        self._diam = {int(k): float(np.linalg.norm(
            np.asarray(v["xyz"]).max(0) - np.asarray(v["xyz"]).min(0)))
            for k, v in cad_bank.items()}
        self._rh = ransac_hypotheses
        self._icp_iters = icp_iters

    def predict(self, *args, **kwargs):
        raise NotImplementedError(_ONLINE)

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
