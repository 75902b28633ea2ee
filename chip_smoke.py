"""GPU smoke run of the PyTorch/CUDA port (pose6d_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (into build/), holds each
kernel against its plain PyTorch version at the main path's shapes
(batch 16), serves cached-mode pose requests on the two committed LM
frames through Predictor(device="cuda") and checks them against the
port's own CPU run, then times a batch of 16 frames. Each phase prints
one JSON line; a failure anywhere raises. The line before the last is
the card's name and power limit (nvidia-smi); the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is unavailable or the package is missing.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES = ROOT / "results_synth_unseen" / "step5737" / \
    "results_poses_RANSAC" / "ply"
# (object id, result folder, file index)
OBJECTS = ((5, "obj_5_result_1", 1), (11, "obj_11_result_0", 0))
BATCH = 16
# one H100 SXM (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32_EPS = 2.0 ** -24


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the same inputs, at the
    main path's shapes with B = 16. Returns the rows of the kernel line."""
    from pose6d_tpu_torch.ops import kernels as K
    g = torch.Generator(device=dev).manual_seed(0)
    B, v1, v2, k = BATCH, 5120, 2048, 5
    rows = {}

    def valid_mask(n, n_valid):
        return torch.arange(n, device=dev).expand(B, n) < n_valid

    # -- kernel 1: flash cross-attention, both directions of a forward
    scale = 16 ** -0.5
    ms = plain_ms = lib_ms = b_ms = 0.0
    err, by = 0.0, ""
    for n, m, m_valid in ((v1, v2, 2000), (v2, v1, 5000)):
        q = torch.randn((B, n, 16, 2), device=dev, generator=g)
        kk = torch.randn((B, m, 16, 2), device=dev, generator=g)
        vv = torch.randn((B, m, 16, 2), device=dev, generator=g)
        kv = valid_mask(m, m_valid)
        out = K.flash_cross_attention(q, kk, vv, kv, scale)
        ref = K.flash_cross_attention_plain(q, kk, vv, kv, scale)
        e = (out - ref).abs().max().item()
        if not e <= 1e-4:   # f32 online vs two-pass softmax, |out| <~ 3
            raise AssertionError(f"flash_cross_attention error {e}")
        err = max(err, e)
        ms += cuda_ms(lambda: K.flash_cross_attention(q, kk, vv, kv, scale),
                      20)
        plain_ms += cuda_ms(
            lambda: K.flash_cross_attention_plain(q, kk, vv, kv, scale), 3)
        qs, ks, vs = (x.permute(0, 3, 1, 2).contiguous() for x in (q, kk, vv))
        mask = kv[:, None, None, :]
        lib_ms += cuda_ms(lambda: torch.nn.functional.
                          scaled_dot_product_attention(qs, ks, vs,
                                                       attn_mask=mask), 20)
        t, by = bound(4 * B * 32 * (2 * n + 2 * m) + B * m,
                      B * 2 * n * m_valid * 4 * 16)
        b_ms += t
    rows["flash_cross_attention"] = dict(
        route="cuda", source="pose6d_tpu_torch/csrc/flash_cross_attention.cu",
        replaces="pose6d_tpu/ops/pallas/attention.py:30",
        max_abs_err=err, tol=1e-4, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=by, library_ms=lib_ms,
        shapes="q (16,5120,16,2) x kv (16,2048,16,2) + the reverse")

    # -- kernel 2: rank-major consistency sums
    P = k * v2
    cad = torch.rand((B, P, 3), device=dev, generator=g) * 20 - 10
    pc = torch.rand((B, v2, 3), device=dev, generator=g) * 20 - 10
    from pose6d_tpu_torch.ops.geometry import pairwise_sqdist
    dpc = torch.sqrt(pairwise_sqdist(pc, pc))
    w = (torch.rand((B, P), device=dev, generator=g) < 0.7).float()
    out = K.consistency_sum_rank_major(cad, dpc, w, v2)
    ref = K.consistency_sum_rank_major_plain(cad, dpc, w, v2)
    err = (out - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()   # f32 sums of ~7k terms, any order
    if not err <= tol:
        raise AssertionError(f"consistency_sum_rank_major error {err} > {tol}")
    n_pairs = float(w.sum().item()) * P
    b_ms, by = bound(4 * B * (3 * P + P + v2 * v2 + P), 12 * n_pairs)
    rows["consistency_sum_rank_major"] = dict(
        route="cuda", source="pose6d_tpu_torch/csrc/consistency_rank_major.cu",
        replaces="pose6d_tpu/ops/pallas/consistency.py:80",
        max_abs_err=err, tol=tol,
        ms=cuda_ms(lambda: K.consistency_sum_rank_major(cad, dpc, w, v2), 10),
        plain_ms=cuda_ms(
            lambda: K.consistency_sum_rank_major_plain(cad, dpc, w, v2), 2),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        shapes="coords (16,10240,3), dpc (16,2048,2048)")

    # -- kernels 3 and 4: masked top-5 (spectral) and argmin (ICP)
    cases = (("masked_topk_cdist", 30, 5, 0.1,
              "pose6d_tpu/ops/pallas/cdist.py:99"),
             ("masked_argmin_cdist", 3, 1, 10.0,
              "pose6d_tpu/ops/pallas/cdist.py:40"))
    for name, c, kk_, spread, replaces in cases:
        a = torch.randn((B, v2, c), device=dev, generator=g) * spread
        b = torch.randn((B, v1, c), device=dev, generator=g) * spread
        bv = valid_mask(v1, 5000)
        if kk_ == 1:
            def kern():
                return K.masked_argmin_cdist(a, b, bv)

            def plain():
                return K.masked_argmin_cdist_plain(a, b, bv)

            def library():
                d = torch.cdist(a, b) ** 2
                return d.masked_fill_(~bv[:, None], math.inf).min(-1)
        else:
            def kern():
                return K.masked_topk_cdist(a, b, bv, kk_)

            def plain():
                return K.masked_topk_cdist_plain(a, b, bv, kk_)

            def library():
                d = torch.cdist(a, b) ** 2
                return torch.topk(d.masked_fill_(~bv[:, None], math.inf),
                                  kk_, largest=False)
        (d_k, i_k), (d_p, i_p) = kern(), plain()
        err = (d_k - d_p).abs().max().item()
        # the |a|^2 - 2ab + |b|^2 expansion cancels to ~eps (|a|^2 + |b|^2)
        scale = (a * a).sum(-1).max().item() + (b * b).sum(-1).max().item()
        tol_t = 1e-5 * d_p.abs() + 16 * F32_EPS * scale
        if not bool(((d_k - d_p).abs() <= tol_t).all()):
            raise AssertionError(f"{name} error {err}")
        mism = int((i_k != i_p).sum().item())
        b_ms, by = bound(4 * B * (v2 * c + v1 * c) + B * v1 + 8 * B * v2 * kk_,
                         2 * c * B * v2 * 5000)
        rows[name] = dict(
            route="cuda", source="pose6d_tpu_torch/csrc/masked_cdist.cu",
            replaces=replaces, max_abs_err=err,
            tol=f"1e-5*|d2| + {16 * F32_EPS * scale:.3g}",
            index_mismatches=mism, ms=cuda_ms(kern, 20),
            plain_ms=cuda_ms(plain, 5), bound_ms=b_ms, bound_by=by,
            library_ms=cuda_ms(library, 5),
            shapes=f"a (16,2048,{c}) x b (16,5120,{c}), k={kk_}")
    for name, row in rows.items():
        emit("kernel_check", name=name, **row)
    return rows


def load_frames():
    from pose6d_tpu_torch.data.ply import read_ply
    from pose6d_tpu_torch.solvers.kabsch import kabsch_umeyama
    from pose6d_tpu_torch.spectral.operators import point_cloud_operators
    frames = []
    for obj, folder, i in OBJECTS:
        d = FRAMES / folder
        cad = read_ply(d / f"cad_{i}.ply")["verts"]
        gt = read_ply(d / f"cad_{i}_pose_gt.ply")["verts"]
        pc = read_ply(d / f"pc_{i}.ply")["verts"]
        R, t = kabsch_umeyama(torch.tensor(cad, dtype=torch.float32)[None],
                              torch.tensor(gt, dtype=torch.float32)[None],
                              torch.ones(1, len(cad)))
        t0 = time.time()
        cad_ops, pc_ops = point_cloud_operators(cad), point_cloud_operators(pc)
        frames.append({"obj": obj, "cad_ops": cad_ops, "pc_ops": pc_ops,
                       "R_gt": R[0].numpy(), "t_gt": t[0].numpy(),
                       "ops_s": time.time() - t0,
                       "diam": float(np.linalg.norm(cad_ops["xyz"].max(0)
                                                    - cad_ops["xyz"].min(0)))})
    return frames


def rot_deg(Ra, Rb) -> float:
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def serve(frames, model, dev):
    """Cached-mode requests through Predictor on the card, then the same
    frames and draws through the port on the CPU. Returns the launch
    counts of the card's run."""
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    bank = {f["obj"]: f["cad_ops"] for f in frames}
    rng = np.random.default_rng(0)
    draws = {f["obj"]: rng.random((256, 512, 3), dtype=np.float32)
             for f in frames}
    reset_launches()
    pred = Predictor(model, bank, device="cuda")
    gpu = {}
    for rnd in range(2):          # round 0 includes first-call set-up
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred.predict_with_operators(f["obj"], f["pc_ops"],
                                              uniforms=draws[f["obj"]])
            ms = 1e3 * (time.perf_counter() - t0)
            gpu[f["obj"]] = out
            emit("request", device="cuda", obj=f["obj"], round=rnd,
                 ms=ms, rot_err_deg=rot_deg(out["R"], f["R_gt"]),
                 t_err_frac_diam=float(np.linalg.norm(out["t"] - f["t_gt"])
                                       / f["diam"]),
                 icp_rmse_cm=float(out["icp_rmse"]),
                 n_inliers=int(out["n_inliers"]),
                 n_trials=int(out["n_trials"]))
    for f in frames:              # the seeded-generator draw path
        out = pred.predict_with_operators(f["obj"], f["pc_ops"], seed=1)
        emit("request", device="cuda", obj=f["obj"], draws="generator",
             rot_err_deg=rot_deg(out["R"], f["R_gt"]),
             n_trials=int(out["n_trials"]))
    counts = dict(LAUNCHES)
    if not all(counts.values()):
        raise AssertionError(f"a kernel was not launched: {counts}")
    emit("profile", obj=frames[0]["obj"], **profile_request(pred, frames[0]))

    cpu_model = type(model)(model.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_pred = Predictor(cpu_model, bank, device="cpu")
    for f in frames:
        t0 = time.perf_counter()
        ref = cpu_pred.predict_with_operators(f["obj"], f["pc_ops"],
                                              uniforms=draws[f["obj"]])
        dr = rot_deg(gpu[f["obj"]]["R"], ref["R"])
        dt = float(np.linalg.norm(gpu[f["obj"]]["t"] - ref["t"]) / f["diam"])
        emit("cpu_agreement", obj=f["obj"], rot_deg=dr, t_frac_diam=dt,
             cpu_s=time.perf_counter() - t0, tol="1 deg, 1 % diam")
        if not (dr <= 1.0 and dt <= 0.01):
            raise AssertionError(f"card and CPU disagree on obj {f['obj']}")
    return counts


def stage_ms(model, cad, pc, diam, reps: int = 3, **pose_kw) -> dict:
    """Each stage of pose_from_operators alone (synchronised between
    stages), CUDA events, mean over `reps` after one warm-up."""
    from pose6d_tpu_torch.api import HYP_BLOCK
    from pose6d_tpu_torch.solvers import (icp_cloud_to_model, ransac_pose,
                                          spatial_filtering_fmap2pointmap)
    nf = model.cfg.n_fmap
    gen = torch.Generator(device=diam.device).manual_seed(0)
    totals = {"forward": 0.0, "filter": 0.0, "ransac": 0.0, "icp": 0.0}

    def timed(name, fn, keep):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        if keep:
            totals[name] += start.elapsed_time(end) / reps
        return out

    with torch.inference_mode():
        for r in range(reps + 1):
            out = timed("forward", lambda: model(cad, pc), r > 0)
            pairs, pvalid = timed("filter", lambda: (
                spatial_filtering_fmap2pointmap(
                    out["C"], cad["evecs"][..., :nf], pc["evecs"][..., :nf],
                    cad["xyz"], pc["xyz"], cad["valid"], pc["valid"],
                    diam)), r > 0)
            src = torch.gather(cad["xyz"], 1,
                               pairs[:, 0, :, None].long().expand(-1, -1, 3))
            dst = torch.gather(pc["xyz"], 1,
                               pairs[:, 1, :, None].long().expand(-1, -1, 3))
            pose = timed("ransac", lambda: ransac_pose(
                src, dst, pvalid, threshold=0.05 * diam,
                n_hypotheses=pose_kw["n_hypotheses"], hyp_block=HYP_BLOCK,
                generator=gen), r > 0)
            timed("icp", lambda: icp_cloud_to_model(
                cad["xyz"], cad["valid"], pc["xyz"], pc["valid"], pose["R"],
                pose["t"], max_corr_dist=0.2 * diam,
                max_iter=pose_kw["icp_iters"],
                coarse_stride=pose_kw["coarse_stride"]), r > 0)
    return totals


def profile_request(pred, frame) -> dict:
    """Device time of 3 B = 1 requests (torch.profiler) over their wall
    time without the profiler: the device busy share; and the kernels
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    def three():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for seed in range(3):
            pred.predict_with_operators(frame["obj"], frame["pc_ops"],
                                        seed=seed)
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0)

    wall_us = three()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        profiled_us = three()
    # device-side rows only (kernels, memcpy, memset): the host ops that
    # launched them carry the same time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    if device_us == 0:
        return {"device_busy_share": "not measured (no device time traced)"}
    return {"wall_ms_per_request": wall_us / 3e3,
            "profiled_wall_ms_per_request": profiled_us / 3e3,
            "device_ms_per_request": device_us / 3e3,
            "device_busy_share": device_us / wall_us,
            "top_device_ms_per_request": {
                e.key[:60]: e.self_device_time_total / 3e3 for e in rows[:8]},
            "device_launches_per_request": sum(e.count for e in rows) / 3}


def batch_throughput(frames, model, dev, gpu_line: str):
    from pose6d_tpu_torch.api import pad_operators, pose_from_operators
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from pose6d_tpu_torch.ops.masking import V_CAD, V_PC
    picks = [frames[i % len(frames)] for i in range(BATCH)]

    def stack(key, v, fs=picks):
        parts = [pad_operators(f[key], v, dev) for f in fs]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    cad, pc = stack("cad_ops", V_CAD), stack("pc_ops", V_PC)
    diam = torch.tensor([f["diam"] for f in picks], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (1, BATCH):
        one = picks[:b]
        c1, p1 = (stack("cad_ops", V_CAD, one), stack("pc_ops", V_PC, one))
        kw = ({"n_hypotheses": 131072, "icp_iters": 30, "coarse_stride": 1}
              if b == 1 else
              {"n_hypotheses": 4096, "icp_iters": 30, "coarse_stride": 4})
        emit("stages", batch=b, recipe=kw, gpu=gpu_line,
             ms=stage_ms(model, c1, p1, diam[:b], **kw))

    def run():
        return pose_from_operators(model, cad, pc, diam, n_hypotheses=4096,
                                   icp_iters=30, coarse_stride=4,
                                   generator=gen)

    reset_launches()
    out = run()
    counts = dict(LAUNCHES)
    for key in ("R", "t"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"non-finite {key} in the batch")
    ms = cuda_ms(run, 3)
    emit("batch_throughput", label="cached-mode path without disambiguation",
         batch=BATCH, frames="8 copies each of the two LM frames",
         ransac_hypotheses=4096, icp_iters=30, coarse_stride=4,
         ms_per_batch=ms, frames_per_s=BATCH * 1e3 / ms, gpu=gpu_line,
         launches=counts,
         note="not comparable with bench.py (other recipe and hardware)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import build_all
    from pose6d_tpu_torch.runtime import configure
    configure()
    dev = torch.device("cuda")
    gpu_line = gpu_name_and_limit()
    emit("device", nvidia_smi=gpu_line, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         tf32=[torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32])

    t0 = time.time()
    reports = build_all()
    emit("build", seconds=time.time() - t0,
         ptxas={src: [ln.strip() for ln in rep.splitlines()
                      if "registers" in ln or "spill" in ln]
                for src, rep in reports.items()})

    rows = check_kernels(dev)

    frames = load_frames()
    emit("frames", objects=[f["obj"] for f in frames],
         cad_points=[len(f["cad_ops"]["xyz"]) for f in frames],
         pc_points=[len(f["pc_ops"]["xyz"]) for f in frames],
         operators_s=[f["ops_s"] for f in frames],
         note="the PLYs carry no faces: the CAD operators are point-cloud "
              "operators too (k_eig 64)")
    model = load_flax_checkpoint(ROOT / "weights" / "synth_seen.msgpack",
                                 DPFMNet()).to(dev).eval()
    counts = serve(frames, model, dev)
    batch_throughput(frames, model, dev, gpu_line)

    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "launches": counts[name],
         **{k: row[k] for k in keys}} for name, row in rows.items()]}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
