"""Pose estimation stage (port of pose6d_tpu/train/pose_stage.py; the
reference's scripts/test_RANSAC.py and test_teaser.py).

Reads the eval result files (train/eval_loop.py, either package's),
estimates poses with RANSAC or GNC-TLS, optionally disambiguates
symmetry flips against the splatted depth, refines with ICP, scores ADD
/ ADD-S / pose errors, and writes the per-instance txt and ply files and
the per-object avg_results.txt in the reference's format. Instances run
through the device in chunks of `batch`.

The reference's ICP target is the GT-posed CAD (test_RANSAC.py:436-439),
kept as icp_target="gt_cad" for baseline comparability; icp_target="pc"
refines against the observed cloud (the production-inference mode).
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..data.ply import write_ply_points
from ..ops.masking import pad_to
from ..ops.symmetry import (detect_symmetries, disambiguation_bank,
                            sym_rotation_error_deg)
from ..runtime import resolve_device
from ..solvers.gnc import INIT_BLOCK, gnc_tls_pose
from ..solvers.icp import icp_cloud_to_model, icp_point2point
from ..solvers.multistart import disambiguate_pose_depth
from ..solvers.ransac import ransac_pose
from . import metrics as metrics_mod

NUM_OBJ = 15  # reference test_RANSAC.py:353
PAIR_PAD = 10240
PT_PAD = 5120
RANSAC_BLOCK = 1024     # ransac_pose's default hypotheses per block
GNC_HYPOTHESES = 4096   # gnc_tls_pose's default triad search
METRICS = ("add_score", "add", "add_score_xyz", "adds_score")


def _splat_observed(pc, K, h: int, w: int):
    """Point-splat the observed cloud back into a depth image (cm) and
    mask, the evidence of depth-render flip disambiguation. The cloud is
    in camera coordinates, so projecting with the frame's own intrinsics
    rebuilds the depth image it came from; a 2x2 footprint fills the
    sampling gaps."""
    z = pc[:, 2]
    ok = z > 1e-6
    u = (K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + K[0, 2]).astype(int)
    v = (K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + K[1, 2]).astype(int)
    ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.zeros((h, w), np.float32)
    zs = z[ok]
    for du in (0, 1):
        for dv in (0, 1):
            uu = np.clip(u[ok] + du, 0, w - 1)
            vv = np.clip(v[ok] + dv, 0, h - 1)
            cur = depth[vv, uu]
            depth[vv, uu] = np.where((cur == 0) | (zs < cur), zs, cur)
    return depth, depth > 0


def draws_shape(solver: str, ransac_hypotheses: int) -> tuple:
    """One instance's solver draws: (n_blocks, block, 3)."""
    if solver == "ransac":
        return (-(-ransac_hypotheses // RANSAC_BLOCK), RANSAC_BLOCK, 3)
    return (-(-GNC_HYPOTHESES // INIT_BLOCK), INIT_BLOCK, 3)


def instance_uniforms(seed: int, i: int, shape: tuple) -> np.ndarray:
    """The solver draws of the i-th result file (in sorted file order),
    f32 in [0, 1), from a generator seeded by (seed, i)."""
    return np.random.default_rng((seed, i)).random(shape, dtype=np.float32)


def _to_T(R, t):
    T = torch.eye(4, dtype=torch.float32, device=R.device).repeat(
        R.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


class _Clock:
    """Per-stage milliseconds accumulated into `ms` (a dict), the device
    synchronised at each stage's end; does nothing when `ms` is None."""

    def __init__(self, ms: dict | None, device):
        self.ms, self.dev = ms, device
        self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.ms is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.ms[stage] = self.ms.get(stage, 0.0) + 1e3 * (now - self.t)
        self.t = now


def _pose_chunk(uniforms, src, dst, pvalid, cad, cad_valid, pc, pc_valid,
                R_gt, t_gt, diam, K, obs_z, obs_mask, has_K, sym_rots, *,
                solver, disambiguate, icp_target, ransac_threshold,
                ransac_hypotheses, gnc_noise_bound, icp_threshold,
                icp_max_iter, gnc_core=False, clock=None):
    """Solver -> (optional flip disambiguation) -> ICP -> metrics for a
    chunk of B instances; every argument has the chunk axis first."""
    clock = clock or _Clock(None, src.device)
    if solver == "ransac":
        est = ransac_pose(src, dst, pvalid, threshold=ransac_threshold,
                          n_hypotheses=ransac_hypotheses,
                          hyp_block=RANSAC_BLOCK, uniforms=uniforms)
    else:
        est = gnc_tls_pose(src, dst, pvalid, noise_bound=gnc_noise_bound,
                           uniforms=uniforms, core_select=gnc_core)
    R_est, t_est = est["R"].float(), est["t"].float()
    clock.mark("solver")

    # flip disambiguation between the solver and the protocol ICP; frames
    # without intrinsics keep the raw solver pose (hypothesis -1)
    if disambiguate:
        fix = disambiguate_pose_depth(cad, cad_valid, pc, pc_valid, R_est,
                                      t_est, diam, K, obs_z, obs_mask,
                                      sym_rots=sym_rots)
        R_init = torch.where(has_K[:, None, None], fix["R"].float(), R_est)
        t_init = torch.where(has_K[:, None], fix["t"].float(), t_est)
        flip_hyp = torch.where(has_K, fix["hypothesis"], -1)
    else:
        R_init, t_init = R_est, t_est
        flip_hyp = torch.full((R_est.shape[0],), -1, dtype=torch.int64,
                              device=R_est.device)
    clock.mark("disambiguation")
    T_est = _to_T(R_est, t_est)
    T_gt = _to_T(R_gt.float(), t_gt.float())

    # ICP: against the GT-posed CAD (protocol), or the observed cloud
    # matched onto the model (production)
    if icp_target == "gt_cad":
        tgt = metrics_mod.transform(cad, T_gt)
        icp = icp_point2point(cad, cad_valid, tgt, cad_valid, R_init, t_init,
                              max_corr_dist=icp_threshold,
                              max_iter=icp_max_iter)
    else:
        icp = icp_cloud_to_model(cad, cad_valid, pc, pc_valid, R_init,
                                 t_init, max_corr_dist=icp_threshold,
                                 max_iter=icp_max_iter)
    T_icp = _to_T(icp["R"].float(), icp["t"].float())
    clock.mark("icp")

    def score_all(T_a, T_b):
        add_e, add_s = metrics_mod.add_score(T_a, T_b, cad, diam, cad_valid)
        add_xyz = metrics_mod.add_score_xyz(T_a, T_b, cad, diam, cad_valid)
        adds_e, adds_s = metrics_mod.adds_score(T_a, T_b, cad, diam,
                                                cad_valid)
        return (add_e, add_s, add_xyz, adds_s), adds_e

    pre, adds_pre = score_all(T_est, T_gt)
    post, adds_post = score_all(T_icp, T_gt)
    out = {"T_est": T_est, "T_icp": T_icp, "T_gt": T_gt,
           "flip_hyp": flip_hyp, "pre": pre, "post": post,
           "err_cm": torch.linalg.norm(t_gt.float() - T_icp[:, :3, 3],
                                       dim=-1),
           "err_deg": torch.rad2deg(metrics_mod.angular_error_rad(
               R_gt.float(), T_icp[:, :3, :3])),
           # the ADD-S distances behind the scores
           "adds_pre": adds_pre, "adds_post": adds_post}
    clock.mark("metrics")
    return out


def _load_records(files, disambiguate: bool):
    """Host pass: load and pad every instance with correspondences;
    instance i keeps its index in the sorted file list (txt names)."""
    recs = []
    for i, f in enumerate(files):
        r = dict(np.load(f, allow_pickle=False))
        P = r["p_pred"].astype(np.int64)
        if len(P) == 0:
            continue
        cad = r["cad_xyz"].astype(np.float32)
        pc = r["pcd_depth"].astype(np.float32)
        rec = {
            "i": i, "obj_id": int(r["obj_id"]), "ir": float(r["ir"]),
            "n_pairs": len(P), "diam": float(r["diam_cad"]),
            "cad": cad, "pc": pc,
            "src": pad_to(cad[P[:, 0]], PAIR_PAD),
            "dst": pad_to(pc[P[:, 1]], PAIR_PAD),
            "pvalid": np.arange(PAIR_PAD) < len(P),
            "R_gt": r["R_m2c"].astype(np.float32),
            "t_gt": r["t_m2c"].astype(np.float32),
        }
        has_K = (disambiguate and "K" in r
                 and float(np.abs(r["K"]).sum()) > 0)
        rec["has_K"] = has_K
        rec["K"] = (r["K"].astype(np.float32) if has_K
                    else np.zeros((3, 3), np.float32))
        hw = r["im_hw"] if "im_hw" in r else np.asarray([480, 640])
        rec["hw"] = (int(hw[0]), int(hw[1]))
        recs.append(rec)
    return recs


def run_pose_stage(results_dir, out_dir, solver: str = "ransac",
                   ransac_threshold: float = 0.05,
                   ransac_hypotheses: int = 131072,
                   gnc_noise_bound: float = 0.05,
                   icp_threshold: float = 0.2, icp_max_iter: int = 50,
                   icp_target: str = "gt_cad", write_ply: bool = True,
                   disambiguate: bool = False, name_suffix: str = "",
                   seed: int = 0, batch: int = 8, gnc_core: bool = False,
                   device="cuda", uniforms=None, stage_ms: dict | None = None,
                   chunks: list | None = None):
    """Returns {"obj_{o}_{metric}": [per-instance values]}.

    disambiguate: depth-render flip disambiguation (solvers/multistart.py)
    between the solver and the protocol ICP; frames whose npz carries no
    intrinsics K, or whose image size is not the modal one, keep the
    solver's pose. batch: instances per device chunk. The solver draws of
    the i-th file come from instance_uniforms(seed, i, ...), or from
    uniforms[i] when `uniforms` (one array per sorted file) is given.
    stage_ms, optional: a dict that receives ms per stage (solver,
    disambiguation, icp, metrics, files), measured with the device
    synchronised at each stage's end. chunks,
    optional: a list that receives each chunk's outputs (numpy).
    """
    dev = resolve_device(device)
    results_dir = Path(results_dir)
    name = ("results_poses_RANSAC" if solver == "ransac" else
            "results_poses_GNC") + name_suffix
    base = Path(out_dir) / name
    (base / "results").mkdir(parents=True, exist_ok=True)
    if write_ply:  # --no-ply runs must not leave an empty ply/ behind
        (base / "ply").mkdir(parents=True, exist_ok=True)

    files = sorted(results_dir.glob("result_*.npz"))
    acc = {f"obj_{i}_{m}": [] for i in range(1, NUM_OBJ + 1)
           for m in METRICS}
    recs = _load_records(files, disambiguate)
    shape = draws_shape(solver, ransac_hypotheses)

    # detected near-symmetries per object (host, once per object): the
    # flip bank of the disambiguation stage and the rotation error
    # modulo symmetry
    sym_bank_by_obj, sym_group_by_obj = {}, {}
    for rec in recs:
        o = rec["obj_id"]
        if o not in sym_bank_by_obj:
            sym_bank_by_obj[o] = disambiguation_bank(rec["cad"], max_rots=6)
            sym_group_by_obj[o] = detect_symmetries(rec["cad"])[0]
        rec["sym_rots"] = sym_bank_by_obj[o]

    if not recs:
        _write_averages(base, acc)
        return acc

    # the evidence images of a chunk share one shape: frames whose image
    # size is not the modal one keep the raw solver pose
    if disambiguate:
        hws = [r["hw"] for r in recs if r["has_K"]]
        if hws:
            modal_hw = max(set(hws), key=hws.count)
            for r in recs:
                if r["has_K"] and r["hw"] != modal_hw:
                    r["has_K"] = False
        else:
            modal_hw = (480, 640)
        h, w = modal_hw
        zero_img = np.zeros((h, w), np.float32)
        for r in recs:
            if r["has_K"]:
                r["obs_z"], r["obs_mask"] = _splat_observed(r["pc"], r["K"],
                                                            h, w)
            else:
                r["obs_z"], r["obs_mask"] = zero_img, zero_img > 0

    def stack(rs, k):
        return torch.as_tensor(np.stack([r[k] for r in rs]), device=dev)

    def padded(rs, k):
        return (torch.as_tensor(np.stack([pad_to(r[k], PT_PAD) for r in rs]),
                                device=dev),
                torch.as_tensor(np.stack([np.arange(PT_PAD) < len(r[k])
                                          for r in rs]), device=dev))

    for lo in range(0, len(recs), batch):
        rs = recs[lo:lo + batch]
        B = len(rs)
        clock = _Clock(stage_ms, dev)
        cad_p, cad_v = padded(rs, "cad")
        pc_p, pc_v = padded(rs, "pc")
        if disambiguate:
            obs_z, obs_mask = stack(rs, "obs_z"), stack(rs, "obs_mask")
        else:
            obs_z = torch.zeros((B, 1, 1), device=dev)
            obs_mask = torch.zeros((B, 1, 1), dtype=torch.bool, device=dev)
        u = np.stack([instance_uniforms(seed, r["i"], shape)
                      if uniforms is None else uniforms[r["i"]] for r in rs])
        with torch.inference_mode():
            out = _pose_chunk(
                torch.as_tensor(u, dtype=torch.float32, device=dev),
                stack(rs, "src"), stack(rs, "dst"),
                stack(rs, "pvalid"), cad_p, cad_v, pc_p, pc_v,
                stack(rs, "R_gt"), stack(rs, "t_gt"),
                torch.tensor([r["diam"] for r in rs], dtype=torch.float32,
                             device=dev),
                stack(rs, "K"), obs_z, obs_mask,
                torch.tensor([r["has_K"] for r in rs], device=dev),
                stack(rs, "sym_rots"), solver=solver,
                disambiguate=disambiguate, icp_target=icp_target,
                ransac_threshold=ransac_threshold,
                ransac_hypotheses=ransac_hypotheses,
                gnc_noise_bound=gnc_noise_bound,
                icp_threshold=icp_threshold, icp_max_iter=icp_max_iter,
                gnc_core=gnc_core, clock=clock)
        out = {k: (tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple)
                   else v.cpu().numpy()) for k, v in out.items()}
        if chunks is not None:
            chunks.append({"i": [r["i"] for r in rs], **out})
        for b, rec in enumerate(rs):
            _write_instance(base, rec, b, out, acc, disambiguate, write_ply,
                            sym_group_by_obj[rec["obj_id"]])
        clock.mark("files")
    _write_averages(base, acc)
    return acc


def _write_instance(base, rec, b, out, acc, disambiguate, write_ply,
                    sym_group) -> None:
    """One instance's txt (the reference's fields, in its order), its
    ply files, and its post-ICP scores into `acc`."""
    obj_id = rec["obj_id"]
    T_est, T_icp, T_gt = (out[k][b].astype(np.float64)
                          for k in ("T_est", "T_icp", "T_gt"))
    add_e, add_s, add_xyz, adds_s = (float(x[b]) for x in out["pre"])
    add_e2, add_s2, add_xyz2, adds_s2 = (float(x[b]) for x in out["post"])
    flip_hyp = int(out["flip_hyp"][b])
    if 1 <= obj_id <= NUM_OBJ:
        for m, x in zip(METRICS, (add_s2, add_e2, add_xyz2, adds_s2)):
            acc[f"obj_{obj_id}_{m}"].append(x)
    err_deg_sym = sym_rotation_error_deg(rec["R_gt"], T_icp[:3, :3],
                                         sym_group)
    extra = (f"Error mod-sym [deg]: {err_deg_sym}\n"
             + (f"Flip hypothesis: {flip_hyp}\n"
                if disambiguate and flip_hyp >= 0 else ""))
    i = rec["i"]
    (base / "results" / f"obj_{obj_id}_result_{i}.txt").write_text(
        f"Object ID: {obj_id}\n"
        f"Inlier ration of P_pred: {rec['ir']}\n"
        f"Num. of correspondences: {rec['n_pairs']}\n"
        f"Avg. Euclidean Distance (ADD) [cm]: {add_e}\n"
        f"Add Score thres: {add_s}\n"
        f"Add Score thres (xyz direction): {add_xyz}\n"
        f"Add-S Score: {adds_s}\n"
        f"Avg. Euclidean Distance (ADD) ICP: {add_e2}\n"
        f"Add Score ICP thres: {add_s2}\n"
        f"Add Score ICP thres (xyz direction): {add_xyz2}\n"
        f"Add-S Score ICP: {adds_s2}\n"
        f"Error [cm]: {float(out['err_cm'][b])}\n"
        f"Error [deg]: {float(out['err_deg'][b])}\n"
        f"T_gt (Ground Truth Transformation):\n{T_gt}\n"
        f"T_pred (Predicted Transformation):\n{T_est}\n"
        f"T_pred_ICP (Predicted Transformation from ICP):\n{T_icp}\n"
        + extra)
    if write_ply:
        d = base / "ply" / f"obj_{obj_id}_result_{i}"
        d.mkdir(parents=True, exist_ok=True)
        cad = rec["cad"]

        def posed(T):   # in f32, as the JAX package transforms it
            T = T.astype(np.float32)
            return cad @ T[:3, :3].T + T[:3, 3]

        write_ply_points(d / f"cad_{i}.ply", cad)
        write_ply_points(d / f"cad_{i}_pose_est.ply", posed(T_icp))
        write_ply_points(d / f"cad_{i}_pose_gt.ply", posed(T_gt))
        write_ply_points(d / f"pc_{i}.ply", rec["pc"])


def _write_averages(base, acc) -> None:
    with open(base / "avg_results.txt", "w") as fh:
        for m in METRICS:
            for o in range(1, NUM_OBJ + 1):
                lst = acc[f"obj_{o}_{m}"]
                avg = float(np.mean(lst)) if lst else 0
                fh.write(f"Average for obj_{o}_{m}: {avg}\n")
