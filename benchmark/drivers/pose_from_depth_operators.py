"""Driver of the batched pose path with depth-render flip disambiguation:
pose6d_tpu_torch.api.pose_from_depth_operators (DPFMNet -> spatial
filter -> RANSAC -> cloud-to-model ICP -> flip bank ICP, depth renders
and score -> the winner's ICP) on a batch of frames whose operators are
cached and whose depth images are kept, batches back to back in a
closed loop.

The pool, the batch's order, the RANSAC draws, the window and the
profiled batches are those of drivers/pose_from_operators.py, whose code
this driver calls; the inputs come from inputs/depth_frames.py (the same
frames, with each frame's depth image, mask and camera). Each frame's
flip bank is ops/symmetry.disambiguation_bank of its CAD, built on the
host in set-up as the Predictor builds it. The traced run drives the
five calls that the entry composes, in its order, with a span around
each of model, filter, ransac, icp and flip; set-up holds the
composition's outputs equal to the entry's, bit for bit.

`correct` holds the base pose as the pose cell does (the entry's R0, t0
and icp_rmse in the places of that cell's R, t and icp_rmse), and the
flip stage frame by frame: the float64 flip stage (reference/flip.py)
fed the program's base pose against the program's final pose
(`flip_apart`, on the frames the float32 witnesses determine: each
chooses the float64 hypothesis and lands within TOL_FLIP of its pose),
and the program's flip_rmse against the float64 rmse of its own final
pose (`flip_rmse_gap`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops_flip, traces
from ..inputs.depth_frames import IMAGE, intrinsics, start_pool
from ..reference import flip as ref_flip
from ..reference import pose as ref_pose
from ..reference.precision import Prec
from . import pose_from_operators as base

TOL_FLIP = 1e-3          # the final pose's gap x diameter (ICP's TOL)


def setup(ctx) -> base.State:
    # the entry first: a program without it fails here, before any
    # worker of the input pool is spawned
    from pose6d_tpu_torch.api import HYP_BLOCK, pad_operators
    from pose6d_tpu_torch.api import pose_from_depth_operators as entry
    run, device, root = ctx["run"], ctx["device"], ctx["root"]
    tr, cfg = run.traffic, run.config
    fm = cfg["model"]["fmap"]
    phases = run.counters.setdefault("setup_phases", {})
    t0 = time.perf_counter()
    job = start_pool(tr["pool_seed"], tr["n_shapes"], tr["poses_per_shape"],
                     max_pc=tr["max_pc"], k_eig=int(fm["k_eig"]),
                     nu=tr.get("nu", 48), nv=tr.get("nv", 96),
                     workers=tr["workers"])
    from pose6d_tpu_torch.models import DPFMConfig, DPFMNet
    from pose6d_tpu_torch.models.weights import load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import build_all
    from pose6d_tpu_torch.ops.symmetry import disambiguation_bank
    from pose6d_tpu_torch.runtime import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_all()
    st = base.State()
    st.run, st.dev, st.root, st.entry = run, dev, root, entry
    st.cuda = dev.type == "cuda"
    model = DPFMNet(DPFMConfig.from_yaml_dict(cfg["model"]))
    st.model = load_flax_checkpoint(root / cfg["weights"], model).to(dev)
    st.model.eval()
    st.hyp_block = min(HYP_BLOCK, tr["n_hypotheses"])
    st.n_blocks = -(-tr["n_hypotheses"] // st.hyp_block)
    bsz = tr["batch"]
    # the first call's lazy initialisation on stand-in inputs of the
    # cell's shapes while the inputs are made
    st.cad, st.pc, st.diam = base.stand_in(st, int(fm["k_eig"]))
    st.K = torch.as_tensor(intrinsics(), device=dev).expand(bsz, 3, 3)
    st.obs_z = torch.zeros((bsz, *IMAGE), device=dev)
    st.obs_z[:, ::2, ::2] = 100.0
    st.mask = st.obs_z > 0
    st.sym_rots = torch.eye(3, device=dev).expand(
        bsz, tr["flip_max_rots"], 3, 3).contiguous()
    u = base.draws(st, -10**6)
    call_entry(st, u)
    composed(st, u, traces.Spans(False))
    base.sync(st)
    phases["program_init_s"] = time.perf_counter() - t0
    pool = job.result()            # the inputs, made meanwhile
    phases["inputs_wait_s"] = (time.perf_counter() - t0
                               - phases["program_init_s"])
    for s in pool:
        s["bank"] = disambiguation_bank(np.asarray(s["cad_ops"]["xyz"]),
                                        max_rots=tr["flip_max_rots"])
    st.frames = [(s, f) for s in pool for f in s["frames"]]
    if bsz % len(st.frames):
        raise ValueError("the batch must hold every frame equally often")
    order = np.random.default_rng(base._seed_of(run.seed, 5)).permutation(
        bsz)
    st.slots = [st.frames[b % len(st.frames)] for b in order]

    def stack(parts):
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    st.cad = stack([pad_operators(s["cad_ops"], tr["v_cad"], dev)
                    for s, _ in st.slots])
    st.pc = stack([pad_operators(f["pc_ops"], tr["v_pc"], dev)
                   for _, f in st.slots])
    st.diam = torch.tensor([s["diam"] for s, _ in st.slots],
                           dtype=torch.float32, device=dev)
    st.obs_z, st.mask, st.sym_rots = (
        torch.as_tensor(np.stack(x), device=dev)
        for x in zip(*[(f["depth_cm"], f["mask"], s["bank"])
                       for s, f in st.slots]))
    st.outs = {}
    st.composition_gap = 0.0
    for w in range(tr["warmup_batches"]):
        u = base.draws(st, -1 - w)
        entry = call_entry(st, u)
        comp = composed(st, u, traces.Spans(False))
        st.composition_gap = max(st.composition_gap, *(
            float((entry[k].double() - comp["out"][k].double()).abs().max())
            for k in entry))
    base.sync(st)
    phases["warm_up_s"] = (time.perf_counter() - t0
                           - phases["program_init_s"]
                           - phases["inputs_wait_s"])
    return st


def call_entry(st, u) -> dict:
    tr = st.run.traffic
    with torch.inference_mode():
        return st.entry(
            st.model, st.cad, st.pc, st.diam, st.K, st.obs_z, st.mask,
            st.sym_rots, n_hypotheses=tr["n_hypotheses"],
            icp_iters=tr["icp_iters"], coarse_stride=tr["coarse_stride"],
            uniforms=u)


def composed(st, u, span, means: bool = False) -> dict:
    """The calls pose_from_depth_operators makes, in its order: the pose
    cell's four (drivers/pose_from_operators.composed, a span around
    each), then disambiguate_pose_depth at the traffic's recipe inside
    span("flip"). Returns the entry's outputs ("out") and the stages'
    ("filter", "ransac", with `means` "means")."""
    from pose6d_tpu_torch.solvers import disambiguate_pose_depth
    tr = st.run.traffic
    res = base.composed(st, u, span, means)
    out = res["out"]
    with torch.inference_mode():
        with span("flip"):
            fix = disambiguate_pose_depth(
                st.cad["xyz"], st.cad["valid"], st.pc["xyz"],
                st.pc["valid"], out["R"], out["t"], st.diam, st.K,
                st.obs_z, st.mask, icp_iters=tr["flip_icp_iters"],
                stride=tr["render_stride"], margin=tr["flip_margin"],
                bank_iters=tr["flip_bank_iters"],
                icp_coarse_stride=tr["flip_coarse_stride"],
                sym_rots=st.sym_rots)
    res["out"] = dict(out, R=fix["R"], t=fix["t"], R0=out["R"], t0=out["t"],
                      flip_hypothesis=fix["hypothesis"],
                      flip_score=fix["score"], flip_rmse=fix["rmse"])
    return res


def window(st, seconds: float, trace: bool) -> None:
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    run = st.run
    bsz = len(st.slots)
    span = traces.Spans(st.cuda)
    reset_launches()
    t_start = time.perf_counter()
    i = 0
    while True:
        u = base.draws(st, i)
        t0 = time.perf_counter()
        if trace:
            with span("batch"):
                out = composed(st, u, span)["out"]
        else:
            out = call_entry(st, u)
        base.sync(st)
        t1 = time.perf_counter()
        run.walls_s.append(t1 - t0)
        run.done.append(bsz)
        st.outs[i] = out
        i += 1
        if t1 - t_start >= seconds:
            break
    run.window_s = t1 - t_start
    run.counters["launches_per_item"] = {k: v / i for k, v in
                                         LAUNCHES.items()}
    run.counters["failed"] = sum(
        int((~torch.isfinite(o["R"]).flatten(1).all(1)
             | ~torch.isfinite(o["t"]).all(1)).sum())
        for o in st.outs.values())
    if trace:
        run.spans = span.collect()
        profile(st)


def profile(st) -> None:
    """A few more batches under torch.profiler, after every timed batch,
    with the program's counters started anew: busy time, the longest idle
    gaps and each stage's operations."""
    from pose6d_tpu_torch.utils import profiling
    tr = st.run.traffic

    def item(j):
        composed(st, base.draws(st, 10**6 + j), traces.Spans(False))
        base.sync(st)

    profiling.reset()
    traces.profile(st.run, st.root, {}, tr["trace_batches"], item, st.cuda,
                   lambda _: {"flops_per_item": stage_flops(st)})


def stage_flops(st) -> dict:
    """The pose cell's stage operations (drivers/pose_from_operators.
    stage_flops) and the flip stage's (flops_flip), one batch."""
    tr = st.run.traffic
    v1s, v2s = base._valid_counts(st)
    h, w = st.obs_z.shape[-2:]
    n_hyp = st.sym_rots.shape[1]
    flip = sum(sum(flops_flip.flip(v1, v2, n_hyp, tr["flip_bank_iters"],
                                   tr["flip_icp_iters"],
                                   tr["flip_coarse_stride"],
                                   h, w, tr["render_stride"]).values())
               for v1, v2 in zip(v1s, v2s))
    return dict(base.stage_flops(st), flip=flip)


# -- correct ---------------------------------------------------------------

def judge(st) -> list:
    """The checks of `correct` (see the module docstring): [{"name",
    "value"}], each passing at most at its limit."""
    got, replay_gap = records(st)
    return summary(readings(st, got)) + [{"name": "replay_gap",
                                          "value": replay_gap}]


def records(st):
    """drivers/pose_from_operators.records with this driver's
    composition: the judged batches' records and the largest replay
    gap; then frees the program's state."""
    tr = st.run.traffic
    rng = np.random.default_rng(base._seed_of(st.run.seed, 11))
    picks = sorted(rng.choice(sorted(st.outs),
                              min(tr["judge_batches"], len(st.outs)),
                              replace=False).tolist())
    got = []
    replay_gap = st.composition_gap
    for i in picks:
        u = base.draws(st, i)
        res = composed(st, u, traces.Spans(False))
        replay_gap = max(replay_gap, max(
            float((res["out"][k].double() - st.outs[i][k].double())
                  .abs().max()) for k in res["out"]))
        got.append(dict(base.program_record(st.outs[i], res, u), i=i))
    for name in ("obs_z", "mask", "sym_rots", "K"):
        delattr(st, name)
    base.release(st)
    return got, replay_gap


def recipe(st) -> dict:
    tr = st.run.traffic
    return {"icp_iters": tr["flip_icp_iters"],
            "bank_iters": tr["flip_bank_iters"],
            "coarse_stride": tr["flip_coarse_stride"],
            "render_stride": tr["render_stride"],
            "margin": tr["flip_margin"], "gate": base.ICP_GATE_DIAM}


def depth_inputs(st, idx, prec: Prec):
    """The reference's own K, depth (cm), mask and bank of the slots idx,
    from the host pool."""
    dev = st.dev
    frames = [st.slots[b][1] for b in idx]
    K = prec.cast(torch.tensor(np.stack([intrinsics()] * len(idx))))
    depth = prec.cast(torch.tensor(np.stack([f["depth_cm"]
                                             for f in frames])))
    mask = torch.tensor(np.stack([f["mask"] for f in frames]))
    bank = prec.cast(torch.tensor(np.stack([st.slots[b][0]["bank"]
                                            for b in idx])))
    return K.to(dev), depth.to(dev), mask.to(dev), bank.to(dev)


def readings(st, got, control: Prec | None = None) -> dict:
    """The pose cell's readings (drivers/pose_from_operators.readings) of
    the base pose, and the flip stage's frame by frame: the candidate
    (the program's final pose and flip_rmse, or with `control` the
    reference's flip stage in that precision fed the program's base
    pose) against the float64 stage fed the program's base pose, with
    the float32 witnesses (WITNESSES of them, jittered as the pose
    cell's) marking the frames whose flip float32 determines."""
    ref, f32 = Prec("f64"), Prec("f32")
    tr, dev = st.run.traffic, st.dev
    as_base = [dict(g, out=dict(g["out"], R=g["out"]["R0"],
                                t=g["out"]["t0"])) for g in got]
    r = base.readings(st, as_base, control)
    rec = recipe(st)
    frames = []
    gap = 0.0
    for g in got:
        bsz = g["out"]["R"].shape[0]
        for c0 in range(0, bsz, tr["ref_chunk"]):
            idx = list(range(c0, min(c0 + tr["ref_chunk"], bsz)))
            out = {k: v[idx].to(dev) for k, v in g["out"].items()}
            R0, t0 = out["R0"].double(), out["t0"].double()
            cad, pc, diam = base.reference_inputs(st, idx, ref)
            with torch.no_grad():
                want = ref_flip.flip_stage(cad, pc, R0, t0, diam,
                                           *depth_inputs(st, idx, ref), rec,
                                           ref)
                wits = []
                for k in range(base.WITNESSES):
                    c, p, d = base.jittered(st, idx, f32, (g["i"], 7, k))
                    wits.append(ref_flip.flip_stage(
                        c, p, R0.float(), t0.float(), d,
                        *depth_inputs(st, idx, f32), rec, f32))
                if control:
                    c, p, d = base.reference_inputs(st, idx, control)
                    cand = ref_flip.flip_stage(
                        c, p, R0.float(), t0.float(), d,
                        *depth_inputs(st, idx, control), rec, control)
                else:
                    cand = {"R": out["R"], "t": out["t"],
                            "rmse": out["flip_rmse"],
                            "hypothesis": out["flip_hypothesis"]}
                rm = ref_pose.rmse_at(cad, pc, cand["R"].double(),
                                      cand["t"].double(),
                                      base.ICP_GATE_DIAM * diam, ref)
            gap = max(gap, float(((cand["rmse"].double() - rm).abs()
                                  / torch.clamp(rm, min=1e-6)).max()))
            frames += flip_frames(cand, want, wits, cad, diam)
    for f, flip in zip(r["per_frame"], frames):
        f.update(flip)
    r["flip_rmse_gap"] = gap
    return r


def flip_frames(cand, want, wits, cad, diam) -> list:
    """Per frame: the candidate's and the witnesses' final pose gaps to
    the float64 stage (x diameter), whether every witness chose its
    hypothesis, and the hypotheses."""
    d = diam.double()
    gap = (base.pose_gap(cand["R"], cand["t"], want["R"], want["t"], cad)
           / d).tolist()
    wit = (torch.stack([base.pose_gap(w["R"], w["t"], want["R"], want["t"],
                                      cad) for w in wits]).amax(0)
           / d).tolist()
    same = torch.stack([w["hypothesis"] == want["hypothesis"]
                        for w in wits]).all(0).tolist()
    return [{"flip": gap[b], "wit_flip": wit[b], "wit_flip_same": same[b],
             "flip_hyp": [int(cand["hypothesis"][b]),
                          int(want["hypothesis"][b])]}
            for b in range(len(gap))]


def flip_apart(frames: list) -> float:
    """Share of the frames whose flip the witnesses determine (each
    chose the float64 hypothesis and landed within TOL_FLIP of its pose)
    on which the candidate's final pose lies more than TOL_FLIP from the
    float64 stage's."""
    kept = [f for f in frames
            if f["wit_flip_same"] and f["wit_flip"] <= TOL_FLIP]
    return sum(f["flip"] > TOL_FLIP for f in kept) / max(len(kept), 1)


def summary(r) -> list:
    return base.summary(r) + [
        {"name": "flip_apart", "value": flip_apart(r["per_frame"])},
        {"name": "flip_rmse_gap", "value": r["flip_rmse_gap"]},
    ]
