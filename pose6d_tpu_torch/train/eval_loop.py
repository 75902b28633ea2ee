"""Correspondence evaluation and result export (port of
pose6d_tpu/train/eval_loop.py; the reference's scripts/eval.py).

Per batch: model forward -> fmap -> point-map solver -> inlier ratio,
aggregated overall and per object id, and optionally one
result_{index:06d}.npz per sample with the JAX package's keys, dtypes
and shapes, which the pose stage (train/pose_stage.py, either package's)
reads. Optional eval-time candidates (ZoomOut, rotation TTA) compete per
sample by depth-render consistency (or spatial-filter survivors).

The dataset is any sequence of (cad_ops, pc_ops, obj) triples (the
training contract, data/dataset.py), by default the BOP dataset of
cfg.eval_dataset (build_eval_dataset). Inside a process group each
process evaluates its strided shard of the frames
(parallel.shard_frame_list) on its own device, names each result file by
the frame's global index, and the per-object IR sums are summed across
processes at the end (parallel.allreduce_metric_sums); without one the
shard is every frame. The pose stage is not sharded.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.dataset import dataset_from_config
from ..data.pipeline import HostLoader, to_device
from ..models import DPFMNet, load_flax_checkpoint
from ..parallel.multihost import allreduce_metric_sums, shard_frame_list
from ..runtime import resolve_device
from ..solvers.candidates import candidate_maps, select_candidate
from ..solvers.fmap2pointmap import (naive_fmap2pointmap,
                                     spatial_filtering_fmap2pointmap)
from ..solvers.ransac import ransac_pose
from ..solvers.verify_pose import depth_consistency_score
from .metrics import inlier_ratio

SELECT_SEED = 7       # the candidate scorer's draws: seeded by (7, index)
SCORE_HYP_BLOCK = 1024
MAX_OBJ = 256         # per-object accumulator size
OUT_KEYS = ("C", "overlap12", "overlap21")   # model outputs kept per sample


class _Subset:
    """Index view over a dataset (this process's shard of the frames)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


def build_eval_dataset(cfg, device="cuda"):
    """The BOP dataset of cfg.eval_dataset, preprocessing on `device`."""
    return dataset_from_config(cfg, cfg.eval_dataset, device)


def make_eval_fns(model, use_spatial: bool):
    """(fwd, solver, ir_fn) for the eval loop: fwd(cad, pc) -> model
    outputs; solver(C, ex, ey, cad_xyz, pc_xyz, x_valid, y_valid, diam)
    -> (pairs, valid); ir_fn = metrics.inlier_ratio."""
    def fwd(cad, pc):
        return model(cad, pc)

    if use_spatial:
        solver = spatial_filtering_fmap2pointmap
    else:
        def solver(C, ex, ey, cx, px, vx, vy, d):
            return naive_fmap2pointmap(C, ex, ey, vx, vy)
    return fwd, solver, inlier_ratio


def _depth_score(hyps: int):
    """Candidate-map scorer: a cheap RANSAC pose from the candidate's
    correspondences (draws `uniforms` (B, n_blocks, 1024, 3)), then its
    depth-render consistency against the splatted observed depth. Lower
    is better."""
    def score(uniforms, cad_xyz, cad_valid, pc_xyz, pairs, pvalid, diam, K,
              obs_z, obs_mask):
        def rows(xyz, idx):
            return torch.gather(xyz, 1,
                                idx.long()[..., None].expand(-1, -1, 3))
        est = ransac_pose(rows(cad_xyz, pairs[:, 0]), rows(pc_xyz, pairs[:, 1]),
                          pvalid, threshold=0.05, n_hypotheses=hyps,
                          hyp_block=SCORE_HYP_BLOCK, uniforms=uniforms)
        return depth_consistency_score(cad_xyz, cad_valid, est["R"],
                                       est["t"], K, obs_z, obs_mask, diam)
    return score


def _batch_candidates(model, solver, batch, cfg) -> list:
    """Candidate maps of one batch, each (out, pairs, pvalid): the raw
    prediction and its ZoomOut upsampling when on, then the same pair
    for every non-identity rotation of the TTA bank
    (solvers/candidates.candidate_maps). The base candidate is first (it
    wins selection ties)."""
    cad, pc, diam = batch["cad"], batch["pc"], batch["diam_cad"]
    cands = candidate_maps(
        model, cad, pc, diam, cfg.model.n_fmap,
        tta_rotations=cfg.eval.tta_rotations, zoomout_k=cfg.eval.zoomout_k,
        zoomout_step=cfg.eval.zoomout_step,
        gate_tau=cfg.eval.zoomout_gate_tau, refine_rotations=True)
    return [(out, *solver(C, cad["evecs"][..., :k], pc["evecs"][..., :k],
                          cad["xyz"], xyz, cad["valid"], pc["valid"], diam))
            for out, C, k, xyz in cands]


def select_uniforms(idx: int, bsz: int, hyps: int) -> np.ndarray:
    """The candidate scorer's RANSAC draws for the batch that starts at
    sample `idx`: (B, n_blocks, 1024, 3) f32 from a generator seeded by
    (7, idx)."""
    n_blocks = -(-hyps // SCORE_HYP_BLOCK)
    return np.random.default_rng((SELECT_SEED, idx)).random(
        (bsz, n_blocks, SCORE_HYP_BLOCK, 3), dtype=np.float32)


def _select_winner(cfg, batch, host, cand_list, idx: int, select_draws):
    """Per-sample winner over candidate maps (lower score wins).

    Signal: depth-render consistency of a cheap RANSAC pose per
    candidate (select_by="depth"), or spatial-filter survivor counts
    (select_by="survivors", and the fallback for a batch in which a
    frame lacks intrinsics or the image sizes differ). Non-base
    candidates carry the select_margin handicap, and compete only on
    samples whose base map is weak (select_trigger). Returns (out,
    pairs, pvalid) as numpy arrays, the winners (B,) and the handicapped
    scores (n_candidates, B)."""
    from .pose_stage import _splat_observed
    margin = 1.0 + cfg.eval.select_margin
    Ks, hws = host["K"], host["im_hw"]
    use_depth = (cfg.eval.select_by == "depth"
                 and float(np.abs(Ks).sum(axis=(1, 2)).min()) > 0
                 and bool((hws == hws[0]).all()))
    if use_depth:
        # the observed clouds splatted once per batch: shared evidence
        h, w = int(hws[0][0]), int(hws[0][1])
        pcs, pvs = host["pc"]["xyz"], host["pc"]["valid"]
        obs = [_splat_observed(pcs[b][pvs[b]], Ks[b], h, w)
               for b in range(pcs.shape[0])]
        dev = batch["diam_cad"].device
        obs_z = torch.as_tensor(np.stack([o[0] for o in obs]), device=dev)
        obs_m = torch.as_tensor(np.stack([o[1] for o in obs]), device=dev)
        hyps = cfg.eval.select_hypotheses
        scorer = _depth_score(hyps)
        draws = select_draws(idx, pcs.shape[0], hyps)
        uniforms = torch.as_tensor(np.asarray(draws, np.float32), device=dev)
        smat = []
        for ci, (_, pr, pv) in enumerate(cand_list):
            s = scorer(uniforms, batch["cad"]["xyz"], batch["cad"]["valid"],
                       batch["pc"]["xyz"], pr, pv, batch["diam_cad"],
                       batch["K"], obs_z, obs_m).cpu().numpy()
            smat.append(s * (margin if ci else 1.0))
    else:
        smat = [-(pv.sum(-1).cpu().numpy() / (margin if ci else 1.0))
                for ci, (_, _, pv) in enumerate(cand_list)]
    smat = np.stack(smat)
    o0, pr0, pv0 = cand_list[0]
    winner = select_candidate(
        torch.as_tensor(smat), pv0.sum(-1).cpu(),
        torch.as_tensor(host["pc"]["valid"].sum(axis=-1)),
        cfg.eval.select_trigger).numpy()
    out = {k: o0[k].cpu().numpy().copy() for k in OUT_KEYS}
    pairs, pvalid = pr0.cpu().numpy().copy(), pv0.cpu().numpy().copy()
    for ci in range(1, len(cand_list)):
        sel = np.where(winner == ci)[0]
        if sel.size:
            o, pr, pv = cand_list[ci]
            pairs[sel] = pr.cpu().numpy()[sel]
            pvalid[sel] = pv.cpu().numpy()[sel]
            for k in OUT_KEYS:
                out[k][sel] = o[k].cpu().numpy()[sel]
    return out, pairs, pvalid, winner, smat


def _load_model(cfg, model_or_params, dev) -> torch.nn.Module:
    if isinstance(model_or_params, torch.nn.Module):
        model = model_or_params
    else:                               # a flax msgpack params file
        model = load_flax_checkpoint(model_or_params, DPFMNet(cfg.model))
    return model.to(dev).eval()


def evaluate(cfg, model_or_params, dataset=None, save_dir=None,
             device="cuda", select_draws=None,
             selection: list | None = None):
    """Returns (mean_ir, {obj_id: mean_ir}) over every process's frames;
    writes this process's result npzs, result_{global index:06d}.npz, to
    save_dir (or cfg.save_results) when one is set.

    model_or_params: a DPFMNet with its weights, or the path of a flax
    msgpack params file. dataset: a sequence of (cad_ops, pc_ops, obj)
    triples, padded to cfg.pad_v_cad / cfg.pad_v_pc, or None for
    build_eval_dataset(cfg) on `device`.
    select_draws(idx, bsz, hyps), optional: the candidate scorer's RANSAC
    draws (B, n_blocks, 1024, 3) for the batch starting at sample idx,
    in place of select_uniforms; idx counts this process's samples (the
    JAX package keys its draws so too). selection, optional: a list that
    receives per sample of this process {"winner": the winning candidate (0 = the base
    map), "scores": each candidate's handicapped score, lower wins, or
    None without candidates}.
    """
    dev = resolve_device(device)
    if dataset is None:
        dataset = build_eval_dataset(cfg, device=dev)
    dataset = _Subset(dataset, shard_frame_list(len(dataset)))
    loader = HostLoader(dataset, cfg.eval.batch_size, shuffle=False,
                        drop_last=False, v_cad=cfg.pad_v_cad,
                        v_pc=cfg.pad_v_pc)
    model = _load_model(cfg, model_or_params, dev)
    n_fmap = cfg.model.n_fmap
    use_spatial = cfg.eval.solver == "spatial_filtering"
    fwd, solver, ir_fn = make_eval_fns(model, use_spatial)
    save_dir = Path(save_dir) if save_dir else (
        Path(cfg.save_results) if cfg.save_results else None)
    if save_dir:
        save_dir.mkdir(parents=True, exist_ok=True)

    if (cfg.eval.tta_rotations > 1 or cfg.eval.zoomout_k) \
            and not use_spatial:
        raise ValueError("eval.tta_rotations / eval.zoomout_k need the "
                         "spatial_filtering solver: its survivor count "
                         "is the candidate-selection signal")
    select_draws = select_draws or select_uniforms

    per_obj: dict[int, list] = {}
    idx = 0
    with torch.inference_mode():
        for host in loader:
            batch = to_device(host, dev)
            cand_list = _batch_candidates(fwd, solver, batch, cfg)
            bsz = host["diam_cad"].shape[0]
            if len(cand_list) == 1:
                out, pairs, pvalid = cand_list[0]
                out = {k: out[k].cpu().numpy() for k in OUT_KEYS}
                pairs, pvalid = pairs.cpu().numpy(), pvalid.cpu().numpy()
                won, smat = np.zeros(bsz, np.int64), None
            else:
                out, pairs, pvalid, won, smat = _select_winner(
                    cfg, batch, host, cand_list, idx, select_draws)
            irs = ir_fn(torch.as_tensor(pairs, device=dev),
                        torch.as_tensor(pvalid, device=dev),
                        batch["cad"]["xyz"], batch["align_pc"],
                        0.1 * batch["diam_cad"]).cpu().numpy()
            if selection is not None:
                selection.extend(
                    {"winner": int(won[b]), "scores": None if smat is None
                     else [float(x) for x in smat[:, b]]} for b in range(bsz))
            for b in range(bsz):
                obj_id = int(host["obj_id"][b])
                ir = float(irs[b])
                per_obj.setdefault(obj_id, []).append(ir)
                if save_dir:
                    gidx = int(dataset.indices[idx])
                    _save_result(save_dir / f"result_{gidx:06d}.npz", host,
                                 b, out, pairs[b][:, pvalid[b]], ir, obj_id,
                                 n_fmap)
                idx += 1
    if per_obj and max(per_obj) >= MAX_OBJ:
        raise ValueError(f"object id {max(per_obj)} >= per-object "
                         f"accumulator size {MAX_OBJ}")
    ir_sum = np.zeros(MAX_OBJ, np.float64)
    cnt = np.zeros(MAX_OBJ, np.float64)
    for k, v in per_obj.items():
        ir_sum[k] += float(np.sum(v))
        cnt[k] += len(v)
    agg = allreduce_metric_sums({"ir_sum": ir_sum, "count": cnt})
    ir_sum, cnt = agg["ir_sum"], agg["count"]
    tot = float(cnt.sum())
    mean_ir = float(ir_sum.sum() / tot) if tot else 0.0
    per_obj_mean = {int(k): float(ir_sum[k] / cnt[k])
                    for k in np.nonzero(cnt)[0]}
    print(f"overall IR: {mean_ir:.4f}")
    for k, v in per_obj_mean.items():
        print(f"  obj_{k} IR: {v:.4f} (n={int(cnt[k])})")
    return mean_ir, per_obj_mean


def _save_result(path, host, b: int, out: dict, pr, ir: float, obj_id: int,
                 n_fmap: int) -> None:
    """One sample's npz, keys / dtypes / shapes as the JAX package
    writes them (its pose stage and cli/resolve.py read them)."""
    nv_c = int(host["cad"]["valid"][b].sum())
    nv_p = int(host["pc"]["valid"][b].sum())
    np.savez(
        path,
        p_pred=pr.T,                     # (N, 2) like the reference P_pred
        C_pred=out["C"][b],
        ir=ir,
        cad_xyz=host["cad"]["xyz"][b][:nv_c],
        pcd_depth=host["pc"]["xyz"][b][:nv_p],
        align_pc=host["align_pc"][b][:nv_p],
        R_m2c=host["R_m2c"][b],
        t_m2c=host["t_m2c"][b],
        diam_cad=float(host["diam_cad"][b]),
        obj_id=obj_id,
        # intrinsics (zeros when the sample has none) for depth-render
        # flip disambiguation
        K=host["K"][b],
        im_hw=host["im_hw"][b],
        overlap12=out["overlap12"][b][:nv_c],
        overlap21=out["overlap21"][b][:nv_p],
        # truncated bases for post-hoc re-solving
        evecs_cad=host["cad"]["evecs"][b][:nv_c, :n_fmap],
        evecs_pc=host["pc"]["evecs"][b][:nv_p, :n_fmap])


__all__ = ["build_eval_dataset", "evaluate", "make_eval_fns",
           "select_uniforms"]
