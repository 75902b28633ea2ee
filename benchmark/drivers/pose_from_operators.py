"""Driver of the batched cached-operator pose path:
pose6d_tpu_torch.api.pose_from_operators (DPFMNet -> spatial filter ->
RANSAC -> cloud-to-model ICP) on a batch of frames whose operators are
cached, batches back to back in a closed loop.

The batch holds every frame of the traffic's pool `batch / frames` times,
in an order drawn from the seed. The pool is made from the traffic's
`pool_seed`, the same in every run: how many RANSAC blocks a batch runs
depends on its frames (one block where every map is strong, all where
one is weak), so a pool drawn from each seed would change the work three
times over. Every batch and every slot of it gets its own RANSAC draws,
from the seed and the batch's index. The traced run drives the same four calls
that the entry composes, in its order, with a span around each; set-up
holds the composition's outputs equal to the entry's, bit for bit.

`correct` follows the window's answers stage by stage (judge): for a
sample of the window's batches drawn from the seed, the composition is
replayed on the same draws (its outputs must equal the window's, bit for
bit) to read the program's own intermediate state; then the float64
reference recomputes each stage: the model from the inputs, the filter
from the program's map, RANSAC from the program's pairs on the same
draws, ICP from the program's RANSAC pose, and each stage's outputs are
compared with the program's; RANSAC and ICP frame by frame, on the
frames whose pose float32 itself determines (TOL, below).
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from .. import flops, traces
from ..inputs.frames import start_pool
from ..reference import model as ref_model
from ..reference import pose as ref_pose
from ..reference.precision import Prec
from ..reference.weights import read_params

TAUS = (0.3, 0.15, 0.055, 0.065)      # the reference repository's schedule
K_CANDIDATES = 5
THRESHOLD_DIAM = 0.05                 # RANSAC inlier distance x diameter
ICP_GATE_DIAM = 0.2                   # ICP correspondence gate x diameter
FINE_ITERS = 5
# RANSAC and ICP are judged frame by frame by the pose gap: the mean
# distance between the CAD's points placed by two poses, over the CAD's
# diameter. The witnesses are the reference's solvers in plain float32
# on the stage's inputs, as they are and WITNESSES - 1 times with the
# points jittered by JITTER of their size. A stage's frame is left out
# where a witness lands more than TOL[stage] from float64: rounding
# decides its pose (near-tied hypotheses, a cloud gated onto one CAD
# point). Elsewhere the candidate is apart beyond TOL[stage]. PERF.md
# gives the readings these were set from.
WITNESSES = 4
JITTER = 2.0 ** -21
TOL = {"ransac": 1e-4, "icp": 1e-3}

KERNEL_GROUPS = {
    "flash_fwd": [r"flash_fwd", "+flash_combine"],
    "topk_cdist": [r"masked_topk_cdist_kernel<5,", "+merge_splits"],
    "argmin_cdist": [r"masked_topk_cdist_kernel<1,", "+merge_splits"],
    "rank_major": [r"consistency_rm_kernel", r"pack_rows_kernel",
                   "+sum_segments"],
}


def _seed_of(*words) -> int:
    return int(np.random.SeedSequence([abs(int(w)) for w in words])
               .generate_state(1, np.uint64)[0] >> 1)


def _pad(x, n):
    x = np.asarray(x)
    out = np.zeros((n,) + x.shape[1:], x.dtype)
    out[:min(len(x), n)] = x[:n]
    return out


class State:
    pass


def setup(ctx) -> State:
    run, device, root = ctx["run"], ctx["device"], Path(ctx["root"])
    tr, cfg = run.traffic, run.config
    fm = cfg["model"]["fmap"]
    phases = run.counters.setdefault("setup_phases", {})
    t0 = time.perf_counter()
    job = start_pool(tr["pool_seed"], tr["n_shapes"], tr["poses_per_shape"],
                     max_pc=tr["max_pc"], k_eig=int(fm["k_eig"]),
                     nu=tr.get("nu", 48),
                     nv=tr.get("nv", 96), workers=tr["workers"])
    from pose6d_tpu_torch.api import HYP_BLOCK, pad_operators
    from pose6d_tpu_torch.models import DPFMConfig, DPFMNet
    from pose6d_tpu_torch.models.weights import load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import build_all
    from pose6d_tpu_torch.runtime import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_all()
    st = State()
    st.run, st.dev, st.root = run, dev, root
    st.cuda = dev.type == "cuda"
    model = DPFMNet(DPFMConfig.from_yaml_dict(cfg["model"]))
    st.model = load_flax_checkpoint(root / cfg["weights"], model).to(dev)
    st.model.eval()
    st.hyp_block = min(HYP_BLOCK, tr["n_hypotheses"])
    st.n_blocks = -(-tr["n_hypotheses"] // st.hyp_block)
    # the first call's lazy initialisation (handles, kernel loading), on
    # stand-in inputs of the cell's shapes while the inputs are made
    st.cad, st.pc, st.diam = stand_in(st, int(fm["k_eig"]))
    u = draws(st, -10**6)
    call_entry(st, u)
    composed(st, u, traces.Spans(False))
    sync(st)
    phases["program_init_s"] = time.perf_counter() - t0
    pool = job.result()            # the inputs, made meanwhile
    phases["inputs_wait_s"] = (time.perf_counter() - t0
                               - phases["program_init_s"])
    st.frames = [(s, f) for s in pool for f in s["frames"]]
    bsz = tr["batch"]
    if bsz % len(st.frames):
        raise ValueError("the batch must hold every frame equally often")
    order = np.random.default_rng(_seed_of(run.seed, 5)).permutation(bsz)
    st.slots = [st.frames[b % len(st.frames)] for b in order]

    def stack(parts):
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    st.cad = stack([pad_operators(s["cad_ops"], tr["v_cad"], dev)
                    for s, _ in st.slots])
    st.pc = stack([pad_operators(f["pc_ops"], tr["v_pc"], dev)
                   for _, f in st.slots])
    st.diam = torch.tensor([s["diam"] for s, _ in st.slots],
                           dtype=torch.float32, device=dev)
    st.outs = {}
    st.composition_gap = 0.0
    for w in range(tr["warmup_batches"]):
        u = draws(st, -1 - w)
        entry = call_entry(st, u)
        comp = composed(st, u, traces.Spans(False))
        st.composition_gap = max(st.composition_gap, *(
            float((entry[k].double() - comp["out"][k].double()).abs().max())
            for k in entry))
    sync(st)
    phases["warm_up_s"] = (time.perf_counter() - t0
                           - phases["program_init_s"]
                           - phases["inputs_wait_s"])
    return st


def stand_in(st, k_eig: int):
    """Random cached operators of the cell's shapes on the card (CAD
    points valid up to 90 %, cloud points up to the FPS count)."""
    tr, dev = st.run.traffic, st.dev
    g = torch.Generator(device=dev).manual_seed(_seed_of(st.run.seed, 13))
    bsz = tr["batch"]

    def shape(v, n_valid, shift):
        valid = (torch.arange(v, device=dev) < n_valid).expand(bsz, v)
        xyz = torch.randn((bsz, v, 3), generator=g, device=dev) * 5 + shift
        evecs = torch.randn((bsz, v, k_eig), generator=g, device=dev)
        return {"xyz": xyz * valid[..., None],
                "mass": valid.float() / n_valid,
                "evals": torch.linspace(0, 1, k_eig, device=dev)
                .expand(bsz, k_eig).contiguous(),
                "evecs": evecs * valid[..., None] / n_valid ** 0.5,
                "valid": valid.contiguous()}

    shift = torch.tensor([0.0, 0.0, 100.0], device=dev)
    return (shape(tr["v_cad"], int(0.9 * tr["v_cad"]), 0.0),
            shape(tr["v_pc"], tr["max_pc"], shift),
            torch.full((bsz,), 20.0, device=dev))


def sync(st):
    if st.cuda:
        torch.cuda.synchronize()


def draws(st, i: int):
    """RANSAC draws of batch i: (B, n_blocks, block, 3) in [0, 1)."""
    g = torch.Generator(device=st.dev).manual_seed(
        _seed_of(st.run.seed, 7, i))
    return torch.rand((st.run.traffic["batch"], st.n_blocks, st.hyp_block,
                       3),
                      generator=g, device=st.dev)


def call_entry(st, u) -> dict:
    from pose6d_tpu_torch.api import pose_from_operators
    tr = st.run.traffic
    return pose_from_operators(st.model, st.cad, st.pc, st.diam,
                               n_hypotheses=tr["n_hypotheses"],
                               icp_iters=tr["icp_iters"],
                               coarse_stride=tr["coarse_stride"],
                               uniforms=u)


def composed(st, u, span, means: bool = False) -> dict:
    """The four calls pose_from_operators makes (through
    candidate_select_pose with the base candidate alone), in its order,
    each inside span(name). Returns the entry's outputs ("out") and the
    stages' ("filter", "ransac"; with `means` each pruning round's
    consistency means)."""
    from pose6d_tpu_torch.solvers import (icp_cloud_to_model, ransac_pose,
                                          spatial_filtering_fmap2pointmap)
    tr, cad, pc, diam = st.run.traffic, st.cad, st.pc, st.diam
    nf = st.model.cfg.n_fmap

    def rows(xyz, idx):
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))

    with torch.inference_mode():
        with span("model"):
            out = st.model(cad, pc)
        with span("filter"):
            filt = spatial_filtering_fmap2pointmap(
                out["C"], cad["evecs"][..., :nf], pc["evecs"][..., :nf],
                cad["xyz"], pc["xyz"], cad["valid"], pc["valid"], diam,
                return_means=means)
        pairs, pvalid = filt[0], filt[1]
        with span("ransac"):
            pose = ransac_pose(rows(cad["xyz"], pairs[:, 0]),
                               rows(pc["xyz"], pairs[:, 1]), pvalid,
                               threshold=THRESHOLD_DIAM * diam,
                               n_hypotheses=tr["n_hypotheses"],
                               hyp_block=st.hyp_block, uniforms=u)
        with span("icp"):
            icp = icp_cloud_to_model(cad["xyz"], cad["valid"], pc["xyz"],
                                     pc["valid"], pose["R"], pose["t"],
                                     max_corr_dist=ICP_GATE_DIAM * diam,
                                     max_iter=tr["icp_iters"],
                                     coarse_stride=tr["coarse_stride"])
    res = {"out": {"R": icp["R"], "t": icp["t"],
                   "n_inliers": pose["n_inliers"],
                   "n_trials": pose["n_trials"],
                   "overlap12": out["overlap12"],
                   "overlap21": out["overlap21"], "C": out["C"],
                   "icp_rmse": icp["rmse"]},
           "filter": (pairs, pvalid), "ransac": pose}
    if means:
        res["means"] = filt[2]
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
        u = draws(st, i)
        t0 = time.perf_counter()
        if trace:
            with span("batch"):
                res = composed(st, u, span)
            out = res["out"]
        else:
            out = call_entry(st, u)
        sync(st)
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
    """A few more batches under torch.profiler, after every timed batch:
    busy time, kernel time by group against each call's least time, the
    longest idle gaps and the host-blocking calls."""
    tr = st.run.traffic

    def item(j):
        res = composed(st, draws(st, 10**6 + j), traces.Spans(False),
                       means=True)
        sync(st)
        return res["means"]

    def extra(means):
        return {"host_syncs_per_item": 0,
                "bounds": least_times(st, means),
                "argmin_coarse_per_item": tr["icp_iters"] - FINE_ITERS,
                "flops_per_item": stage_flops(st)}

    traces.profile(st.run, st.root, KERNEL_GROUPS, tr["trace_batches"],
                   item, st.cuda, extra)
    info = st.run.trace_info
    info["host_syncs_per_item"] = info["sync_calls_per_item"] - 1  # ours


def _valid_counts(st):
    return ([int(v) for v in st.cad["valid"].sum(1)],
            [int(v) for v in st.pc["valid"].sum(1)])


def least_times(st, means_per_batch) -> dict:
    """Least seconds of each kernel group's calls in the profiled batches,
    and which bound applies."""
    tr, cfg = st.run.traffic, st.model.cfg
    v1s, v2s = _valid_counts(st)
    n1, n2 = st.cad["xyz"].shape[1], st.pc["xyz"].shape[1]
    heads, dim = cfg.num_heads, cfg.gnn_dim // cfg.num_heads
    out = {g: {"bytes": 0.0, "f32": 0.0} for g in
           ("flash_fwd", "topk_cdist", "argmin_coarse", "argmin_fine",
            "rank_major")}

    def add(g, d):
        out[g]["bytes"] += d["bytes"]
        out[g]["f32"] += d.get("f32", 0.0)

    n_coarse = tr["icp_iters"] - FINE_ITERS
    stride = tr["coarse_stride"]
    for means in means_per_batch:
        for b, (v1, v2) in enumerate(zip(v1s, v2s)):
            add("flash_fwd", flops.flash_fwd(n1, n2, v2, heads, dim))
            add("flash_fwd", flops.flash_fwd(n2, n1, v1, heads, dim))
            add("topk_cdist", flops.cdist(n2, n1, v1, cfg.n_fmap,
                                          K_CANDIDATES))
            coarse_m = -(-n1 // stride)
            coarse_valid = -(-v1 // stride)
            for _ in range(n_coarse):
                add("argmin_coarse", flops.cdist(n2, coarse_m, coarse_valid,
                                                 3, 1))
            for _ in range(FINE_ITERS + 1):
                add("argmin_fine", flops.cdist(n2, n1, v1, 3, 1))
        # the rows alive in each pruning round, from the rounds' means
        p = K_CANDIDATES * n2
        live = st.pc["valid"].repeat_interleave(K_CANDIDATES, 1)
        for r, m in enumerate(means):
            for b in range(live.shape[0]):
                add("rank_major", flops.rank_major(p, n2,
                                                   int(live[b].sum())))
            if r < len(TAUS) - 2:
                live = live & (m < TAUS[r] * st.diam[:, None])
    return {g: {"least_s": flops.least_s(d["bytes"], d["f32"]),
                "bound": flops.bound_by(d["bytes"], d["f32"])}
            for g, d in out.items()}


def stage_flops(st) -> dict:
    """Operations of one batch by stage, from shapes, valid counts and
    the window's RANSAC trials."""
    cfg, tr = st.model.cfg, st.run.traffic
    v1s, v2s = _valid_counts(st)
    last = st.outs[max(st.outs)]
    trials = [int(x) for x in last["n_trials"]]
    n_hks = cfg.n_hks if "hks" in cfg.input_features else 0
    model = sum(flops.dpfm_forward(v1, v2, cfg.k_eig, cfg.n_fmap,
                                   cfg.input_width, cfg.width, cfg.n_blocks,
                                   cfg.n_feat, cfg.gnn_dim, cfg.num_heads,
                                   cfg.overlap_feat_dim, n_hks)
                for v1, v2 in zip(v1s, v2s))
    filt = sum(2 * v1 * cfg.n_fmap * cfg.n_fmap
               + flops.cdist(v2, v1, v1, cfg.n_fmap, K_CANDIDATES)["f32"]
               + 3 * 12 * (K_CANDIDATES * v2) ** 2
               for v1, v2 in zip(v1s, v2s))
    ransac = sum(flops.ransac(K_CANDIDATES * v2, t)
                 for v2, t in zip(v2s, trials))
    stride = tr["coarse_stride"]
    icp = sum((tr["icp_iters"] - FINE_ITERS) * 6 * v2 * -(-v1 // stride)
              + (FINE_ITERS + 1) * 6 * v2 * v1 + tr["icp_iters"] * 60 * v2
              for v1, v2 in zip(v1s, v2s))
    return {"model": model, "filter": filt, "ransac": ransac, "icp": icp,
            "trials_per_frame": sum(trials) / len(trials)}


# -- correct ---------------------------------------------------------------

def judge(st) -> list:
    """The checks of `correct` (see the module docstring): [{"name",
    "value"}], each passing at most at its limit."""
    got, replay_gap = records(st)
    return summary(readings(st, got)) + [{"name": "replay_gap",
                                          "value": replay_gap}]


def records(st):
    """The program's records of the judged batches (drawn from the seed
    among the window's), and the largest gap between a replay and the
    window's outputs (and between the composition and the entry in
    set-up); then frees the program's state."""
    tr = st.run.traffic
    rng = np.random.default_rng(_seed_of(st.run.seed, 11))
    picks = sorted(rng.choice(sorted(st.outs),
                              min(tr["judge_batches"], len(st.outs)),
                              replace=False).tolist())
    got = []
    replay_gap = st.composition_gap
    for i in picks:
        u = draws(st, i)
        res = composed(st, u, traces.Spans(False))
        replay_gap = max(replay_gap, max(
            float((res["out"][k].double() - st.outs[i][k].double())
                  .abs().max()) for k in res["out"]))
        got.append(dict(program_record(st.outs[i], res, u), i=i))
    release(st)
    return got, replay_gap


def program_record(out, res, u) -> dict:
    """What the reference reads of one program batch, on the host: the
    window's outputs and the stage outputs that feed the next stage."""
    pairs, pvalid = res["filter"]
    stage = {"cad_idx": pairs[:, 0], "pvalid": pvalid,
             "ransac": {k: res["ransac"][k]
                        for k in ("R", "t", "n_inliers", "n_trials")}}
    host = lambda d: {k: (host(v) if isinstance(v, dict)  # noqa: E731
                          else v.cpu()) for k, v in d.items()}
    return {"out": host(dict(out)), "stage": host(stage), "u": u.cpu()}


def release(st) -> None:
    """Free the program's device state before the reference runs."""
    for name in ("model", "cad", "pc", "outs"):
        if hasattr(st, name):
            delattr(st, name)
    if st.cuda:
        torch.cuda.empty_cache()


def rot_deg(Ra, Rb):
    """Angle between rotations from |Ra - Rb|_F = sqrt(8) sin(angle / 2)."""
    d = torch.linalg.matrix_norm(Ra.double() - Rb.double())
    return torch.rad2deg(2 * torch.asin(torch.clamp(d / math.sqrt(8.0),
                                                    max=1.0)))


def reference_inputs(st, idx, prec: Prec):
    """The reference's own padded tensors of the slots idx, from the host
    pool (not from the program's tensors)."""
    tr, dev = st.run.traffic, st.dev

    def block(opss, v):
        d = {k: prec.cast(torch.tensor(np.stack([_pad(o[k], v)
                                                 for o in opss]))).to(dev)
             for k in ("xyz", "mass", "evecs")}
        d["evals"] = prec.cast(torch.tensor(np.stack(
            [o["evals"] for o in opss]))).to(dev)
        d["valid"] = torch.tensor(np.stack(
            [np.arange(v) < len(o["xyz"]) for o in opss])).to(dev)
        return d

    cad = block([st.slots[b][0]["cad_ops"] for b in idx], tr["v_cad"])
    pc = block([st.slots[b][1]["pc_ops"] for b in idx], tr["v_pc"])
    diam = prec.cast(torch.tensor([st.slots[b][0]["diam"] for b in idx],
                                  dtype=torch.float32)).to(dev)
    return cad, pc, diam


def model_stages(st, prec: Prec, params, cad, pc, diam, C) -> dict:
    """The model from the inputs and the filter from the program's map C,
    in precision `prec`."""
    nf = int(st.run.config["model"]["fmap"]["n_fmap"])
    m = ref_model.forward(params, st.run.config["model"], cad, pc, prec)
    cad_idx, fvalid = ref_pose.spatial_filter(
        C.to(prec.dtype), cad, pc, diam, nf, K_CANDIDATES, TAUS, prec)
    return {"C": m["C"], "overlap12": m["overlap12"],
            "overlap21": m["overlap21"], "cad_idx": cad_idx,
            "pvalid": fvalid}


def solver_stages(st, prec: Prec, cad, pc, diam, inp, u) -> dict:
    """RANSAC from the program's pairs (inp: cad_idx, pvalid) on the
    draws u, and ICP from the program's RANSAC pose (inp["ransac"]), in
    precision `prec`."""
    tr, d = st.run.traffic, prec.dtype
    src = torch.gather(cad["xyz"], 1, inp["cad_idx"].long()[..., None]
                       .expand(-1, -1, 3))
    dst = pc["xyz"].repeat_interleave(K_CANDIDATES, 1)
    rp = ref_pose.ransac(src, dst, inp["pvalid"], THRESHOLD_DIAM * diam, u,
                         prec)
    ri = ref_pose.icp(cad, pc, inp["ransac"]["R"].to(d),
                      inp["ransac"]["t"].to(d), ICP_GATE_DIAM * diam,
                      tr["icp_iters"], tr["coarse_stride"], prec, FINE_ITERS)
    return {"ransac": rp, "R": ri["R"], "t": ri["t"], "icp_rmse": ri["rmse"]}


def readings(st, got, control: Prec | None = None) -> dict:
    """The compared numbers' raw readings over the batches `got`: the
    program's stage outputs, or with `control` those of the reference in
    that precision put in the program's place (each stage fed the
    program's input to it), against the float64 reference. The
    witnesses (see TOL) mark the frames whose RANSAC or ICP pose float32
    itself cannot determine."""
    ref, f32 = Prec("f64"), Prec("f32")
    tr, cfg, dev = st.run.traffic, st.run.config, st.dev
    params = {p.name: ref_model.params_to(
        read_params(st.root / cfg["weights"]), p, dev)
        for p in [ref] + ([control] if control else [])}
    r = {"C_gap": 0.0, "overlap_gap": 0.0, "filter_apart": 0,
         "filter_slots": 0, "rmse_gap": 0.0, "per_frame": []}
    for g in got:
        bsz = g["out"]["C"].shape[0]
        for c0 in range(0, bsz, tr["ref_chunk"]):
            idx = list(range(c0, min(c0 + tr["ref_chunk"], bsz)))
            to = lambda d: {k: (to(v) if isinstance(v, dict)  # noqa: E731
                                else v[idx].to(dev)) for k, v in d.items()}
            out, inp, u = to(g["out"]), to(g["stage"]), g["u"][idx].to(dev)
            cad, pc, diam = reference_inputs(st, idx, ref)
            with torch.no_grad():
                want = dict(model_stages(st, ref, params["f64"], cad, pc,
                                         diam, out["C"]),
                            **solver_stages(st, ref, cad, pc, diam, inp, u))
                wits = [solver_stages(st, f32,
                                      *jittered(st, idx, f32, (g["i"], k)),
                                      inp, u) for k in range(WITNESSES)]
                if control:
                    c_in = reference_inputs(st, idx, control)
                    cand = dict(model_stages(st, control,
                                             params[control.name], *c_in,
                                             out["C"]),
                                **solver_stages(st, control, *c_in, inp, u))
                else:
                    cand = dict(out, cad_idx=inp["cad_idx"],
                                pvalid=inp["pvalid"], ransac=inp["ransac"])
                rm = ref_pose.rmse_at(cad, pc, cand["R"].double(),
                                      cand["t"].double(),
                                      ICP_GATE_DIAM * diam, ref)
            accumulate(r, cand, want, wits, rm, cad, pc["valid"], diam)
    return r


def jittered(st, idx, prec: Prec, key):
    """reference_inputs, the points scaled by 1 + JITTER z (z normal, drawn
    from the seed and `key`) unless key[-1] is 0."""
    cad, pc, diam = reference_inputs(st, idx, prec)
    if key[-1]:
        g = torch.Generator(device=st.dev).manual_seed(
            _seed_of(st.run.seed, 17, idx[0], *key))
        for s in (cad, pc):
            z = torch.randn(s["xyz"].shape, generator=g, device=st.dev,
                            dtype=s["xyz"].dtype)
            s["xyz"] = s["xyz"] * (1 + JITTER * z)
    return cad, pc, diam


def pose_gap(Ra, ta, Rb, tb, cad):
    """Mean distance between the CAD's valid points placed by pose a and
    by pose b (model to camera), in the CAD's units."""
    x, w = cad["xyz"].double(), cad["valid"].double()
    d = (x @ (Ra.double() - Rb.double()).transpose(-1, -2)
         + (ta.double() - tb.double())[:, None, :])
    return ((torch.linalg.vector_norm(d, dim=-1) * w).sum(-1)
            / torch.clamp(w.sum(-1), min=1.0))


def accumulate(r, cand, want, wits, rmse_want, cad, pc_valid, diam) -> None:
    cr = want["C"]
    r["C_gap"] = max(r["C_gap"], float(
        ((cand["C"].double() - cr).abs().amax((1, 2))
         / cr.abs().amax((1, 2))).max()))
    for k in ("overlap12", "overlap21"):
        r["overlap_gap"] = max(r["overlap_gap"], float(
            (cand[k].double() - want[k]).abs().max()))
    slot_ok = pc_valid.repeat_interleave(K_CANDIDATES, 1)
    diff = (((cand["cad_idx"].long() != want["cad_idx"])
             | (cand["pvalid"] != want["pvalid"])) & slot_ok)
    r["filter_apart"] += int(diff.sum())
    r["filter_slots"] += int(slot_ok.sum())
    r["rmse_gap"] = max(r["rmse_gap"], float(
        ((cand["icp_rmse"].double() - rmse_want).abs()
         / torch.clamp(rmse_want, min=1e-6)).max()))
    wr, cr_ = want["ransac"], cand["ransac"]
    gaps = {"ransac": pose_gap(cr_["R"], cr_["t"], wr["R"], wr["t"], cad),
            "icp": pose_gap(cand["R"], cand["t"], want["R"], want["t"], cad),
            "wit_ransac": torch.stack([pose_gap(
                w["ransac"]["R"], w["ransac"]["t"], wr["R"], wr["t"], cad)
                for w in wits]).amax(0),
            "wit_icp": torch.stack([pose_gap(
                w["R"], w["t"], want["R"], want["t"], cad)
                for w in wits]).amax(0)}
    gaps = {k: (v / diam.double()).tolist() for k, v in gaps.items()}
    rot = {"ransac_deg": rot_deg(cr_["R"], wr["R"]).tolist(),
           "icp_deg": rot_deg(cand["R"], want["R"]).tolist()}
    for b in range(len(diam)):
        r["per_frame"].append(dict(
            {k: v[b] for k, v in gaps.items()},
            **{k: v[b] for k, v in rot.items()},
            survivors=int(cand["pvalid"][b].sum()),
            n_inliers=[int(cr_["n_inliers"][b]), int(wr["n_inliers"][b])]))


def apart_share(frames: list, stage: str) -> float:
    """Share of the frames whose `stage` pose the witnesses determine
    (each lands within TOL[stage] of the float64 reference's) on which
    the candidate's pose lies more than TOL[stage] from the reference's."""
    kept = [f for f in frames if f["wit_" + stage] <= TOL[stage]]
    return sum(f[stage] > TOL[stage] for f in kept) / max(len(kept), 1)


def summary(r) -> list:
    return [
        {"name": "C_gap", "value": r["C_gap"]},
        {"name": "overlap_gap", "value": r["overlap_gap"]},
        {"name": "filter_apart",
         "value": r["filter_apart"] / max(r["filter_slots"], 1)},
        {"name": "ransac_apart",
         "value": apart_share(r["per_frame"], "ransac")},
        {"name": "icp_apart", "value": apart_share(r["per_frame"], "icp")},
        {"name": "rmse_gap", "value": r["rmse_gap"]},
    ]
