"""GPU smoke run of the PyTorch/CUDA port (pose6d_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (into build/), holds each
kernel against its plain PyTorch version at the main path's shapes
(batch 16; the serve path's kernels also at batch 1 and on edge inputs,
the masked cdist kernels also on ICP's coarse shape and at ZoomOut's
64 features) and counts the
instructions of the issue-bound kernels' inner loops. Then the online
path: two rendered 640 x 480 depth frames of random_shape meshes through
Predictor(device="cuda").predict (depth -> cloud -> device LBO -> pose ->
flip disambiguation), timed per stage, held stage by stage against the
port's CPU run, and a batch of 16 through candidate_select_pose ->
disambiguate_pose_depth. Then cached-mode pose requests on the two
committed LM frames through predict_with_operators, checked against the
port's own CPU run, a timed batch of 16 frames, and training. Then the
evaluation protocol on four instances (the LM frames and the rendered
ones): evaluate() at the reference's settings and with TTA + ZoomOut,
run_pose_stage (RANSAC with disambiguation, GNC) on its result files and
the pose CLI, each repeated on the card (bit for bit) and held against
the port's CPU run on the instances and inputs whose answer is
determined. Then the README's command-line workflow (cli_workflow):
gen_shapes -> synth_data -> generate_cache -> train -> eval -> pose ->
ir_extraction on two random_shape objects at lm_synth.yaml's width,
the cache held against the CPU. Then the model-selection workflow on
that run (model_selection: probe_ckpts over the kept checkpoints, swa,
eval of the SWA params, resolve at top-k 3, 5 and 8, with another
pruning schedule and naive, sym_ir, visualize corr; card against CPU)
and train_repeat (two train() runs of one seed on one cache, bit for
bit). Then ZoomOut on a well-conditioned pair and one Predictor.predict
with TTA + ZoomOut candidates, card against CPU. kernel_check also holds
the top-k and rank-major kernels at k = 1, 3, 5, 8 and 16, and the
online frames also go through Predictor(fps_groups=8)
(online_grouped_fps: grouped FPS picks equal to the CPU's).
Each phase prints one
JSON line; a failure anywhere raises. The line before the
last is the card's name and power limit (nvidia-smi); the last line is
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
TRAIN_BATCH = 8
# one H100 SXM (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32_EPS = 2.0 ** -24


# the kernels each driven path must launch (its counts are set to 0 just
# before the path runs and read just after)
PATH_KERNELS = {
    "serve": ("flash_cross_attention", "consistency_sum_rank_major",
              "masked_topk_cdist", "masked_argmin_cdist"),
    "online": ("flash_cross_attention", "consistency_sum_rank_major",
               "masked_topk_cdist", "masked_argmin_cdist"),
    "pc_major_filter": ("masked_topk_cdist", "masked_consistency_sum"),
    "train": ("flash_cross_attention", "flash_cross_attention_backward",
              "masked_argmin_cdist"),
    "eval": ("flash_cross_attention", "consistency_sum_rank_major",
             "masked_topk_cdist", "masked_argmin_cdist",
             "masked_consistency_sum"),
    "pose_stage": ("masked_argmin_cdist",),
    "variants": ("flash_cross_attention", "flash_cross_attention_backward"),
    "variant_serve": ("flash_cross_attention", "consistency_sum_rank_major",
                      "masked_topk_cdist", "masked_argmin_cdist"),
    # cli_workflow: the in-process train, eval and pose CLI runs
    "cli": ("flash_cross_attention", "flash_cross_attention_backward",
            "consistency_sum_rank_major", "masked_topk_cdist",
            "masked_argmin_cdist"),
    # model_selection: probe_ckpts, swa + eval, resolve (in process)
    "model_selection": ("flash_cross_attention", "masked_topk_cdist",
                        "consistency_sum_rank_major", "masked_argmin_cdist"),
}


def launched(names, path: str) -> dict:
    """The launch counts since the last reset; raises if a kernel of
    `names` was not launched."""
    from pose6d_tpu_torch.ops.kernels import LAUNCHES
    counts = dict(LAUNCHES)
    missing = [n for n in names if not counts[n]]
    if missing:
        raise AssertionError(f"{path}: not launched: {missing} ({counts})")
    return counts


T_START = time.perf_counter()
# every phase line is also appended here: the whole run's record, where a
# caller keeps only the end of the output
LOG = ROOT / "build" / "chip_smoke.jsonl"


def emit(phase: str, **fields) -> None:
    """One JSON line per phase result; `t_s` is the script's elapsed time."""
    line = json.dumps({"phase": phase, **fields,
                       "t_s": round(time.perf_counter() - T_START, 1)})
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call without the host's cost to launch it, which
    at B = 1 can exceed the kernel's: `reps` calls captured in one CUDA
    graph, the graph replayed three times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the same inputs, at the
    main path's shapes with B = 16, and the serve path's kernels also at
    B = 1 (a one-frame request). Returns the rows of the kernel line."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {"flash_cross_attention": check_flash_forward(dev, g),
            "consistency_sum_rank_major": check_rank_major(dev, g)}
    rows.update(check_cdist(dev, g))
    rows["flash_cross_attention_backward"] = check_flash_backward(dev, g)
    rows["masked_consistency_sum"] = check_masked_consistency(dev, g)
    rows["masked_topk_cdist"]["by_k"] = topk_by_k(dev, g)
    rows["consistency_sum_rank_major"]["by_k"] = rank_major_by_k(dev, g)
    rows["flash_cross_attention"]["instances"] = flash_instances(dev, g)
    rows["flash_cross_attention_backward"]["instances"] = \
        flash_backward_instances(dev, g)
    for name, row in rows.items():
        emit("kernel_check", name=name, **row)
    return rows


def prefix_mask(bsz, n, n_valid, dev):
    """(bsz, n) bool, the first n_valid[f % len(n_valid)] entries of
    frame f valid: the padding of the serve and batch paths."""
    lim = torch.tensor([n_valid[f % len(n_valid)] for f in range(bsz)],
                       device=dev)
    return torch.arange(n, device=dev)[None] < lim[:, None]


# the refiner's two calls of a forward: (queries, keys, valid keys) with
# the timing counts kept from earlier rows of the kernel table, and the
# serve path's valid counts for LM obj 11 (622 PC points, 5002 CAD)
FLASH_CALLS = ((5120, 2048, 2000), (2048, 5120, 5000))
FLASH_SERVE = ((5120, 2048, 622), (2048, 5120, 5002))
# lse of the kernel against torch.logsumexp: f32 sums of <= 5120 terms in
# another order (and the segments' merge), elementwise
LSE_TOL = "1e-5 * (1 + |L|)"


def flash_case(name, q, kk, vv, kv, segments=None) -> dict:
    """Two launches of the forward with lse (bit-identical, and equal to
    serving's launch without lse) against the plain version (1e-4: f32
    online against two-pass softmax, |out| <~ 3) and lse against
    torch.logsumexp of the masked scores; a row with no valid key must
    give zeros and lse = -inf. `segments` forces the key split (else
    the wrapper's plan). Returns the case's numbers."""
    from pose6d_tpu_torch.ops import kernels as K
    from pose6d_tpu_torch.ops.kernels.attention import (_forward_kernel,
                                                        flash_segments_on,
                                                        kernel_instance)
    scale = q.shape[2] ** -0.5
    (o1, l1), (o2, l2) = (_forward_kernel(q, kk, vv, kv, scale, True,
                                          segments) for _ in range(2))
    o3 = (K.flash_cross_attention(q, kk, vv, kv, scale) if segments is None
          else _forward_kernel(q, kk, vv, kv, scale, False, segments)[0])
    if not (torch.equal(o1, o2) and torch.equal(l1, l2)
            and torch.equal(o1, o3)):
        raise AssertionError(f"flash {name}: launches differ")
    err = (o1 - K.flash_cross_attention_plain(q, kk, vv, kv, scale)
           ).abs().max().item()
    s = torch.einsum("bndh,bmdh->bnhm", q, kk) * scale
    lref = torch.logsumexp(s.masked_fill(~kv[:, None, None], -math.inf), -1)
    has = kv.any(-1)
    lerr = (l1[has] - lref[has]).abs()
    if not (err <= 1e-4 and bool((lerr <= 1e-5 * (1 + lref[has].abs())).all())
            and bool((l1[~has] == -math.inf).all()) and not o1[~has].any()):
        raise AssertionError(f"flash {name}: out {err}, lse {lerr.max()}, "
                             "or a key-less frame wrong")
    bsz, n, dim, heads = q.shape
    frames, kheads = kernel_instance(bsz, dim, heads)
    return dict(max_abs_err=err, lse_max_err=lerr.max().item(),
                segments=segments or flash_segments_on(q.device, frames, n,
                                                       kk.shape[1], kheads,
                                                       dim))


def check_flash_forward(dev, g) -> dict:
    """Kernel 1, the forward of both refiner calls: at B = 1 (the key
    walk split across blocks) and B = 16, timed (graph replay and from
    the host) on FLASH_CALLS, then held to the plain version and the
    plain log-sum-exp on those, on the serve path's prefix masks, at
    B = 16 unsplit (one segment forced), and on 3 valid keys in one
    segment, a frame without keys, and N = 2000."""
    from pose6d_tpu_torch.ops import kernels as K
    scale = 16 ** -0.5

    def inputs(bsz, n, m, n_valid):
        q, kk, vv = (torch.randn((bsz, s, 16, 2), device=dev, generator=g)
                     for s in (n, m, m))
        return q, kk, vv, prefix_mask(bsz, m, n_valid, dev)

    def timed(bsz):
        t = dict.fromkeys(("ms", "call_ms", "plain_ms", "library_ms",
                           "library_call_ms", "bound_ms"), 0.0)
        cases = {}
        for n, m, m_valid in FLASH_CALLS:
            q, kk, vv, kv = inputs(bsz, n, m, [m_valid])
            cases[f"{n}x{m}"] = flash_case(f"B={bsz} {n}x{m}", q, kk, vv, kv)

            def kern():
                return K.flash_cross_attention(q, kk, vv, kv, scale)
            qs, ks, vs = (x.permute(0, 3, 1, 2).contiguous()
                          for x in (q, kk, vv))
            mask = kv[:, None, None, :]

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask)
            t["ms"] += graph_ms(kern)
            t["call_ms"] += cuda_ms(kern, 20)
            t["plain_ms"] += cuda_ms(lambda: K.flash_cross_attention_plain(
                q, kk, vv, kv, scale), 3)
            t["library_ms"] += graph_ms(library, 5)
            t["library_call_ms"] += cuda_ms(library, 5)
            b_ms, by = bound(4 * bsz * 32 * (2 * n + 2 * m) + bsz * m,
                             bsz * 2 * n * m_valid * 4 * 16)
            t["bound_ms"] += b_ms
        err = max(c["max_abs_err"] for c in cases.values())
        return dict(t, bound_by=by, max_abs_err=err, cases=cases)

    b16, b1 = timed(BATCH), timed(1)
    cases = {}
    for bsz in (1, BATCH):
        for n, m, m_valid in FLASH_SERVE:
            cases[f"B={bsz} {n}x{m}, {m_valid} valid"] = flash_case(
                f"B={bsz} {n}x{m} prefix", *inputs(bsz, n, m, [m_valid]))
    # the unsplit path, as the planner takes it for a large enough grid
    n, m, m_valid = FLASH_CALLS[0]
    cases[f"B={BATCH} {n}x{m}, {m_valid} valid, one segment"] = flash_case(
        "unsplit", *inputs(BATCH, n, m, [m_valid]), segments=1)
    q, kk, vv, kv = inputs(3, 2000, 5120, [5120])
    kv[0] = False
    kv[0, 100:103] = True                      # 3 keys, one tile
    kv[1] = False                              # no key at all
    cases["B=3 2000x5120: all / 3 valid / none"] = flash_case(
        "edges", q, kk, vv, kv)
    return dict(
        route="cuda", source="pose6d_tpu_torch/csrc/flash_cross_attention.cu",
        replaces="pose6d_tpu/ops/pallas/attention.py:30",
        tol=f"out 1e-4 abs; lse {LSE_TOL}", lse_tol=LSE_TOL,
        **{k: b16[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "library_call_ms")},
        b1={k: b1[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_call_ms",
                               "max_abs_err")},
        by_batch={"b16": b16["cases"], "b1": b1["cases"]}, cases=cases,
        shapes="q (16,5120,16,2) x kv (16,2048,16,2), 2000 valid keys, + "
               "the reverse, 5000 valid; b1: the same at B = 1",
        timing="ms and library_ms: device time per call of both calls "
               "(graph replay); call_ms: back-to-back calls from the host")


# the flash kernels' other instances on the refiner's shapes: head dim 32
# (attention_type="double": 64 / 2 heads, 128 / 4 wide) and the wide
# model's 4 heads at dim 16
FLASH_INSTANCES = ((32, 2), (32, 4), (16, 4))


def flash_instances(dev, g) -> dict:
    """The forward's instances of FLASH_INSTANCES at B = 1 and B = 16 on
    FLASH_CALLS, each held to the plain version as flash_case holds the
    default one, timed as check_flash_forward times it (both calls of a
    forward summed). Returns {"dim x heads": {"b1": ..., "b16": ...}}."""
    from pose6d_tpu_torch.ops import kernels as K
    out = {}
    for dim, heads in FLASH_INSTANCES:
        scale, row = dim ** -0.5, {}
        for bsz in (1, BATCH):
            t = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"),
                              0.0)
            errs, by = [], ""
            for n, m, m_valid in FLASH_CALLS:
                q, kk, vv = (torch.randn((bsz, s, dim, heads), device=dev,
                                         generator=g) for s in (n, m, m))
                kv = prefix_mask(bsz, m, [m_valid], dev)
                case = flash_case(f"dim {dim} H {heads} B={bsz} {n}x{m}", q,
                                  kk, vv, kv)
                errs.append(case["max_abs_err"])
                qs, ks, vs = (x.permute(0, 3, 1, 2).contiguous()
                              for x in (q, kk, vv))
                mask = kv[:, None, None, :]
                t["ms"] += graph_ms(lambda: K.flash_cross_attention(
                    q, kk, vv, kv, scale))
                t["plain_ms"] += cuda_ms(lambda: K.flash_cross_attention_plain(
                    q, kk, vv, kv, scale), 2)
                t["library_ms"] += graph_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask), 5)
                b_ms, by = bound(4 * bsz * dim * heads * (2 * n + 2 * m)
                                 + bsz * m,
                                 bsz * n * m_valid * heads * 2 * dim * 2)
                t["bound_ms"] += b_ms
                emit("kernel_case", name="flash_cross_attention",
                     case=f"dim {dim} x {heads} heads, B={bsz} {n}x{m}, "
                          f"{m_valid} valid", **case)
            row[f"b{bsz}"] = dict(t, bound_by=by, max_abs_err=max(errs))
        out[f"{dim}x{heads}"] = row
    return out


def flash_backward_instances(dev, g) -> dict:
    """The backward's FLASH_INSTANCES at B = 8 on
    FLASH_BWD_CALLS (frame 3 without keys), held to autograd through the
    plain version as flash_backward_case holds the default instance;
    timed by graph replay, autograd through SDPA beside. Returns {"dim x
    heads": {...}} with both calls summed."""
    from pose6d_tpu_torch.ops import kernels as K
    out = {}
    for dim, heads in FLASH_INSTANCES:
        t = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_tc_ms"), 0.0)
        errs, by, segs = [], "", []
        for n, m, n_valid, m_valid in FLASH_BWD_CALLS:
            res, kern, (q, kk, vv, kv, dout) = flash_backward_case(
                f"dim {dim} H {heads} {n}x{m}", dev, g, n, m, n_valid,
                m_valid, dim=dim, heads=heads)
            bnd = backward_bounds(TRAIN_BATCH, n, m, res["pairs"], dim, heads)
            res.update(ms=graph_ms(kern), **bnd)
            emit("kernel_case", name="flash_cross_attention_backward",
                 case=f"dim {dim} x {heads} heads, B=8 {n}x{m}, "
                      f"{n_valid} / {m_valid} valid, frame 3 key-less", **res)
            errs.append(res["max_abs_err"])
            segs.append(res["segments"])
            t["plain_ms"] += cuda_ms(
                lambda: K.flash_cross_attention_backward_plain(
                    q, kk, vv, kv, dim ** -0.5, dout), 2)
            qs, ks, vs = (x.permute(0, 3, 1, 2).contiguous().requires_grad_()
                          for x in (q, kk, vv))
            lo = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=kv[:, None, None, :])
            do = dout.permute(0, 3, 1, 2).contiguous()
            t["library_ms"] += cuda_ms(lambda: torch.autograd.grad(
                lo, (qs, ks, vs), do, retain_graph=True), 5)
            for key in ("ms", "bound_ms", "bound_tc_ms"):
                t[key] += res[key]
            by = bnd["bound_by"]
        out[f"{dim}x{heads}"] = dict(t, bound_by=by, max_abs_err=max(errs),
                                     segments=segs)
    return out


def check_rank_major(dev, g) -> dict:
    """Kernel 2 at B = 1 (the row walk split across blocks) and B = 16,
    timed (graph replay and from the host) with 70 % of the rows live at
    random (the kernel table's timing inputs), then held to the plain
    version on the serve path's prefix-live weights (2000 and 622 of 2048
    per rank group), on V2 = 2000 frames with every row live / a rank all
    zero / all zero (exact zeros out), and on endpoints that repeat, as
    real frames' do (timed too); two launches bit-identical in every
    case. Also counts the non-negative floats where the kernel's square
    root differs from sqrtf (all 2^31)."""
    from pose6d_tpu_torch.ops import kernels as K
    from pose6d_tpu_torch.ops.geometry import pairwise_sqdist
    from pose6d_tpu_torch.ops.kernels import _build
    from pose6d_tpu_torch.ops.kernels.consistency import \
        rank_major_segments_on

    def inputs(bsz, v2, live=None):
        cad = torch.rand((bsz, 5 * v2, 3), device=dev, generator=g) * 20 - 10
        pc = torch.rand((bsz, v2, 3), device=dev, generator=g) * 20 - 10
        dpc = torch.sqrt(pairwise_sqdist(pc, pc))
        if live is None:
            w = (torch.rand((bsz, 5 * v2), device=dev, generator=g)
                 < 0.7).float()
        else:
            w = prefix_mask(bsz, v2, live, dev).float().repeat(1, 5)
        return cad, dpc, w

    def case(name, cad, dpc, w, v2) -> dict:
        o1 = K.consistency_sum_rank_major(cad, dpc, w, v2)
        o2 = K.consistency_sum_rank_major(cad, dpc, w, v2)
        ref = K.consistency_sum_rank_major_plain(cad, dpc, w, v2)
        err = (o1 - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()  # f32 sums of ~7k terms, any order
        dead = w.sum(-1) == 0
        if not (torch.equal(o1, o2) and err <= tol
                and not o1[dead].any()):
            raise AssertionError(f"rank-major {name}: error {err} > {tol}, "
                                 "launches differ, or a dead frame non-zero")
        return dict(max_abs_err=err, tol=tol,
                    segments=rank_major_segments_on(dev, cad.shape[0], v2))

    def timed(bsz):
        cad, dpc, w = inputs(bsz, 2048)
        res = case(f"B={bsz}", cad, dpc, w, 2048)
        # coords, w and dpc read once, the sums written once; 12 flops
        # per live (row, column) pair
        p = 5 * 2048
        b_ms, by = bound(4 * bsz * (3 * p + p + 2048 * 2048 + p),
                         12 * float(w.sum().item()) * p)

        def kern():
            return K.consistency_sum_rank_major(cad, dpc, w, 2048)

        def library():      # as row 5's: cdist, the PC table tiled 5 x 5
            da = torch.cdist(cad, cad)
            return torch.einsum("bi,bij->bj", w,
                                (da - dpc.repeat(1, 5, 5)).abs_())
        return dict(res, ms=graph_ms(kern), call_ms=cuda_ms(kern, 10),
                    plain_ms=cuda_ms(lambda: K.consistency_sum_rank_major_plain(
                        cad, dpc, w, 2048), 2),
                    bound_ms=b_ms, bound_by=by, library_ms=cuda_ms(library, 2))

    c16, c1 = timed(BATCH), timed(1)
    cases = {}
    for bsz, live in ((1, [622]), (1, [2000]), (BATCH, [2000, 622])):
        cases[f"B={bsz}, live prefix {live}"] = case(
            f"prefix {live}", *inputs(bsz, 2048, live), 2048)
    cad, dpc, w = inputs(3, 2000, [2000, 1500, 0])
    w.view(3, 5, 2000)[1, 2] = 0.0             # one rank without live rows
    cases["B=3, V2=2000: all / prefix 1500 with rank 2 dead / none"] = case(
        "edges", cad, dpc, w, 2000)
    # as on real frames, where the top-5 candidates of nearby PC points
    # share CAD points: endpoints drawn from 1024 points, so many pairs
    # are a point and itself (distance exactly 0)
    for bsz in (1, BATCH):
        cad, dpc, w = inputs(bsz, 2048, [2000, 622])
        pick = torch.randint(0, 1024, (bsz, 5 * 2048), device=dev, generator=g)
        cad = torch.gather(cad, 1, pick[..., None].expand(-1, -1, 3))
        cases[f"B={bsz}, endpoints from 1024 points"] = dict(
            case("shared endpoints", cad, dpc, w, 2048),
            ms=graph_ms(lambda: K.consistency_sum_rank_major(cad, dpc, w,
                                                             2048)))
    lib = _build.library("consistency_rank_major.cu")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    _build.check(lib.consistency_rank_major_sqrt_check(
        bad.data_ptr(), _build.stream_ptr(dev)), "sqrt check")
    if int(bad.item()):
        raise AssertionError(f"kernel sqrt differs from sqrtf on "
                             f"{int(bad.item())} floats")
    return dict(
        route="cuda", source="pose6d_tpu_torch/csrc/consistency_rank_major.cu",
        replaces="pose6d_tpu/ops/pallas/consistency.py:80",
        **{k: c16[k] for k in ("max_abs_err", "tol", "ms", "call_ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "segments")},
        b1={k: c1[k] for k in ("max_abs_err", "tol", "ms", "call_ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "segments")},
        cases=cases, sqrt_mismatches_of_2e31=int(bad.item()),
        shapes="coords (16,10240,3), dpc (16,2048,2048), 70 % rows live; "
               "b1: the same at B = 1",
        timing="ms: device time per call (graph replay); call_ms: "
               "back-to-back calls from the host")


# (label, frames, b rows, valid b rows): a one-frame request, the B = 16
# batch, and ICP's coarse target at the batch path's stride 4
CDIST_SHAPES = (("b1", 1, 5120, 5000), ("b16", BATCH, 5120, 5000),
                ("b16_coarse", BATCH, 1280, 1250))


def cdist_fns(k: int):
    """(kernel, plain, library) for k = 1 (argmin) or k = 5 (top-5),
    each returning (d2 (B, N, k), idx (B, N, k)); the library call is
    torch.cdist squared, masked, then min or topk."""
    from pose6d_tpu_torch.ops import kernels as K

    def kern(a, b, bv):
        if k == 1:
            d, i = K.masked_argmin_cdist(a, b, bv)
            return d[..., None], i[..., None]
        return K.masked_topk_cdist(a, b, bv, k)

    def plain(a, b, bv):
        if k == 1:
            d, i = K.masked_argmin_cdist_plain(a, b, bv)
            return d[..., None], i[..., None]
        return K.masked_topk_cdist_plain(a, b, bv, k)

    def library(a, b, bv):
        d = (torch.cdist(a, b) ** 2).masked_fill_(~bv[:, None], math.inf)
        return d.min(-1) if k == 1 else torch.topk(d, k, largest=False)

    return kern, plain, library


# (normal spread, grid step, clip) of the exact-grid inputs, by C: the
# spectral embedding's scale for C = 30, centimetres for ICP's C = 3
CDIST_GRIDS = {30: (0.05, 2.0 ** -10, 0.125), 64: (0.05, 2.0 ** -10, 0.125),
               3: (5.0, 2.0 ** -6, 10.0)}
# ZoomOut's nearest-neighbour shape: (frames, queries, columns, valid
# columns, features); the ZoomOut candidate's top-5 runs at the same C
CDIST_ZOOMOUT = (8, 2048, 5120, 5000, 64)


def grid_points(shape, c, dev, g):
    """Normal draws rounded to C's grid and clipped. Every product, sum
    and d2 of the expansion is then a multiple of step^2 below 2^24
    steps, exact in f32 in any summation order: the kernel and the plain
    version must agree bit for bit, exact ties included."""
    spread, step, lim = CDIST_GRIDS[c]
    x = torch.randn(shape, device=dev, generator=g) * spread
    return (torch.round(x / step) * step).clamp_(-lim, lim)


def compare_cdist(name, kern, plain, a, b, bv) -> dict:
    """Two launches of the kernel (bit-identical) against the plain
    version on exact-grid inputs: d2 and indices equal. Returns the
    kernel's output and the case's numbers."""
    (dk, ik), (dk2, ik2), (dp, ip) = kern(a, b, bv), kern(a, b, bv), \
        plain(a, b, bv)
    if not (torch.equal(dk, dk2) and torch.equal(ik, ik2)):
        raise AssertionError(f"{name}: two launches differ")
    mism = int((ik != ip).sum().item())
    err = (dk - dp).abs().max().item()
    if mism or err:
        raise AssertionError(f"{name}: {mism} index mismatches, d2 {err} "
                             "apart on exact inputs")
    return dict(out=(dk, ik), max_abs_err=err, index_mismatches=mism)


def real_valued_cdist(name, kern, plain, c, dev, g) -> dict:
    """Real-valued normal draws (no grid) at B = 16, 2048 x 5120: d2
    within the expansion's f32 error of the plain version (the two sum
    in other orders); an index may differ only where the two columns'
    float64 distances lie within twice that error of each other, a
    near-tie that the two orders break differently."""
    spread = CDIST_GRIDS[c][0]
    a = torch.randn((BATCH, 2048, c), device=dev, generator=g) * spread
    b = torch.randn((BATCH, 5120, c), device=dev, generator=g) * spread
    bv = torch.arange(5120, device=dev).expand(BATCH, 5120) < 5000
    (dk, ik), (dp, ip) = kern(a, b, bv), plain(a, b, bv)
    # the |a|^2 - 2ab + |b|^2 expansion cancels to ~eps (|a|^2 + |b|^2)
    scale = (a * a).sum(-1).max().item() + (b * b).sum(-1).max().item()
    tol = 1e-5 * dp.abs() + 16 * F32_EPS * scale
    if not bool(((dk - dp).abs() <= tol).all()):
        raise AssertionError(f"{name} real-valued: d2 beyond tolerance")
    swap = ik != ip
    fr, row, _ = torch.nonzero(swap, as_tuple=True)

    def d64(idx):
        return ((a[fr, row].double() - b[fr, idx.long()].double()) ** 2
                ).sum(-1)

    gap = (d64(ik[swap]) - d64(ip[swap])).abs()
    unexplained = int((gap > 2 * tol[swap].double()).sum().item())
    if unexplained:
        raise AssertionError(f"{name} real-valued: {unexplained} index "
                             "mismatches beyond a near-tie")
    return dict(max_abs_err=(dk - dp).abs().max().item(),
                tol=f"1e-5*|d2| + {16 * F32_EPS * scale:.3g}",
                index_mismatches=unexplained,
                near_tie_swaps=int(swap.sum().item()),
                shape=f"a (16,2048,{c}) x b (16,5120,{c}), normal, "
                      f"5000 valid")


def check_cdist(dev, g) -> dict:
    """Kernels 3 and 4, the masked top-5 (spectral candidates, C = 30)
    and the masked argmin (ICP, C = 3): at the three CDIST_SHAPES and
    on edge inputs, on exact-grid inputs, each held to the plain version
    bit for bit (0 index mismatches) with two launches bit-identical;
    and once on real-valued inputs, within the f32 expansion's error."""
    rows = {}
    n = 2048
    for name, c, k, replaces in (
            ("masked_topk_cdist", 30, 5, "pose6d_tpu/ops/pallas/cdist.py:99"),
            ("masked_argmin_cdist", 3, 1, "pose6d_tpu/ops/pallas/cdist.py:40")):
        kern, plain, library = cdist_fns(k)
        shapes = {}
        for label, bsz, m, m_valid in CDIST_SHAPES:
            a = grid_points((bsz, n, c), c, dev, g)
            b = grid_points((bsz, m, c), c, dev, g)
            bv = torch.arange(m, device=dev).expand(bsz, m) < m_valid
            res = compare_cdist(f"{name} {label}", kern, plain, a, b, bv)
            del res["out"]
            b_ms, by = bound(4 * bsz * (n * c + m * c) + bsz * m
                             + 8 * bsz * n * k, 2 * c * bsz * n * m_valid)
            shapes[label] = dict(
                res, ms=graph_ms(lambda: kern(a, b, bv)),
                call_ms=cuda_ms(lambda: kern(a, b, bv), 20),
                plain_ms=cuda_ms(lambda: plain(a, b, bv), 3),
                library_ms=graph_ms(lambda: library(a, b, bv), 5),
                library_call_ms=cuda_ms(lambda: library(a, b, bv), 5),
                bound_ms=b_ms, bound_by=by,
                shape=f"a ({bsz},{n},{c}) x b ({bsz},{m},{c}), "
                      f"{m_valid} valid")
        edges = cdist_edges(name, kern, plain, c, dev, g)
        real = real_valued_cdist(name, kern, plain, c, dev, g)
        wide = cdist_zoomout(name, kern, plain, library, k, dev, g)
        main = shapes["b16"]
        rows[name] = dict(
            route="cuda", source="pose6d_tpu_torch/csrc/masked_cdist.cu",
            replaces=replaces, max_abs_err=real["max_abs_err"],
            tol="exact-grid cases: equal d2 and indices; real-valued: "
                + real["tol"],
            index_mismatches=sum(r["index_mismatches"] for r in
                                 (*shapes.values(), edges, real, wide)),
            **{key: main[key] for key in ("ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
            b1={key: shapes["b1"][key] for key in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_call_ms")},
            c64=wide, by_shape=shapes, edges=edges, real_valued=real,
            shapes=f"a (16,2048,{c}) x b (16,5120,{c}), k={k}; by_shape: "
                   "B = 1, B = 16, and B = 16 x 1280 b rows",
            timing="ms and library_ms: device time per call (calls replayed "
                   "as a CUDA graph); call_ms: back-to-back calls from the "
                   "host, launch cost included")
    return rows


def cdist_zoomout(name, kern, plain, library, k, dev, g) -> dict:
    """The kernel at C = 64 (the layout for 32 < C <= 64) at ZoomOut's
    shape, B = 8 x 2048 queries x 5120 columns, on exact-grid inputs
    with exact ties (adjacent equal columns among the first 64) and
    masked columns (the last 120, and 5 % at random): held to the plain
    version bit for bit, timed against its bound."""
    bsz, n, m, m_valid, c = CDIST_ZOOMOUT
    a = grid_points((bsz, n, c), c, dev, g)
    b = grid_points((bsz, m, c), c, dev, g)
    b[:, 1:64:2] = b[:, 0:64:2]
    bv = (torch.arange(m, device=dev).expand(bsz, m) < m_valid) & (
        torch.rand((bsz, m), device=dev, generator=g) > 0.05)
    res = compare_cdist(f"{name} c64", kern, plain, a, b, bv)
    del res["out"]
    n_valid = int(bv.sum().item())
    b_ms, by = bound(4 * bsz * (n * c + m * c) + bsz * m + 8 * bsz * n * k,
                     2 * c * n * n_valid)
    return dict(res, ms=graph_ms(lambda: kern(a, b, bv), 10),
                call_ms=cuda_ms(lambda: kern(a, b, bv), 10),
                plain_ms=cuda_ms(lambda: plain(a, b, bv), 2),
                library_ms=graph_ms(lambda: library(a, b, bv), 3),
                bound_ms=b_ms, bound_by=by,
                shape=f"a ({bsz},{n},{c}) x b ({bsz},{m},{c}), {n_valid} "
                      "valid in all, ties")


def cdist_edges(name, kern, plain, c, dev, g) -> dict:
    """Three frames of 2000 queries (a multiple of no tile) x 5120 b
    rows on the exact grid: frame 0 with exact ties (adjacent equal rows
    among the first 64, and every row equal to the one 2560 later:
    across the column segments that a few frames get), frame 1 with 3
    valid columns in three segments, frame 2 with none."""
    n, m, half = 2000, 5120, 2560
    a = grid_points((3, n, c), c, dev, g)
    b = grid_points((3, m, c), c, dev, g)
    b[0, 1:64:2] = b[0, 0:64:2]
    b[0, half:] = b[0, :half]
    bv = torch.ones((3, m), dtype=torch.bool, device=dev)
    bv[1] = False
    bv[1, [7, 2600, 5100]] = True
    bv[2] = False
    res = compare_cdist(f"{name} edges", kern, plain, a, b, bv)
    d2, idx = res.pop("out")
    k = idx.shape[-1]
    # frame 0: a later twin is taken only after its (valid) earlier one
    i0 = idx[0]
    twin = torch.where(i0 >= half, i0 - half,
                       torch.where((i0 < 64) & (i0 % 2 == 1), i0 - 1, -1))
    late = 0
    for s in range(k):
        has = twin[:, s] >= 0
        seen = (i0[:, :s] == twin[:, s:s + 1]).any(-1)
        late += int((has & ~seen).sum().item())
    fill = (d2[2] == 1e9).all() and (idx[2] == 0).all()
    if k > 3:
        fill = fill and (d2[1, :, 3:] == 1e9).all() and \
            (idx[1, :, 3:] == 0).all()
    if late or not bool(fill):
        raise AssertionError(f"{name} edges: {late} later twins first, "
                             f"fill ok {bool(fill)}")
    return dict(res, later_twin_first=late,
                shape=f"a (3,{n},{c}) x b (3,{m},{c}): ties / 3 valid / none")


# the k of the widened kernels' checks: every instance of the
# top-k kernel (1, 5, 8, 16) and a k that slices one (3), and the same k
# for the rank-major sums (chunks of 1, 3, 5, 4 x 2 and 4 x 4 ranks)
WIDE_K = (1, 3, 5, 8, 16)


def topk_by_k(dev, g) -> dict:
    """Kernel 3 at each k of WIDE_K on the spectral shape (C = 30, 2048
    queries x 5120 columns, 5000 valid) at B = 1 and B = 16, on
    exact-grid inputs held to the plain version bit for bit (indices and
    d2, two launches identical), and on three frames with 3 valid / no
    valid / all columns (rows with fewer valid columns than k: the
    k-pass's (1e9, 0) fill up to k = 8, lax.top_k's masked columns
    above); timed by graph replay, with its bound and torch.cdist +
    torch.topk."""
    from pose6d_tpu_torch.ops import kernels as K
    n, m, m_valid, c = 2048, 5120, 5000, 30
    out = {}
    for k in WIDE_K:
        def kern(a, b, bv):
            return K.masked_topk_cdist(a, b, bv, k)

        def plain(a, b, bv):
            return K.masked_topk_cdist_plain(a, b, bv, k)

        def library(a, b, bv):
            d = (torch.cdist(a, b) ** 2).masked_fill_(~bv[:, None], math.inf)
            return torch.topk(d, k, largest=False)

        row = {}
        for label, bsz in (("b1", 1), ("b16", BATCH)):
            a = grid_points((bsz, n, c), c, dev, g)
            b = grid_points((bsz, m, c), c, dev, g)
            bv = torch.arange(m, device=dev).expand(bsz, m) < m_valid
            res = compare_cdist(f"top-{k} {label}", kern, plain, a, b, bv)
            del res["out"]
            b_ms, by = bound(4 * bsz * (n * c + m * c) + bsz * m
                             + 8 * bsz * n * k, 2 * c * bsz * n * m_valid)
            row[label] = dict(res, ms=graph_ms(lambda: kern(a, b, bv)),
                              plain_ms=cuda_ms(lambda: plain(a, b, bv), 2),
                              library_ms=graph_ms(lambda: library(a, b, bv),
                                                  3),
                              bound_ms=b_ms, bound_by=by)
        a = grid_points((3, 2000, c), c, dev, g)
        b = grid_points((3, m, c), c, dev, g)
        bv = torch.ones((3, m), dtype=torch.bool, device=dev)
        bv[0] = False
        bv[0, [7, 2600, 5100]] = True
        bv[1] = False
        res = compare_cdist(f"top-{k} few valid", kern, plain, a, b, bv)
        d2, idx = res.pop("out")
        if k > 3 and not bool((d2[:2, :, 3:] == 1e9).all()):
            raise AssertionError(f"top-{k}: a row without k valid columns "
                                 "is not filled with 1e9")
        row["few_valid"] = dict(res, shape="a (3,2000,30) x b (3,5120,30): "
                                "3 valid / none / all")
        out[f"k={k}"] = row
    return out


def rank_major_by_k(dev, g) -> dict:
    """Kernel 2 at each k of WIDE_K at V2 = 2048 (70 % of the rows live)
    at B = 1 and B = 16, against the plain version within 1e-4 of the
    largest sum, two launches identical, a frame with no live row all
    zero; timed by graph replay, with its bound and cdist + einsum over
    the PC table tiled k x k (frame by frame where the batched tables
    would not fit)."""
    from pose6d_tpu_torch.ops import kernels as K
    from pose6d_tpu_torch.ops.geometry import pairwise_sqdist
    from pose6d_tpu_torch.ops.kernels.consistency import (
        rank_major_chunks, rank_major_segments_on)
    v2 = 2048
    out = {}
    for k in WIDE_K:
        p = k * v2
        row = {}
        for label, bsz in (("b1", 1), ("b16", BATCH)):
            cad = torch.rand((bsz, p, 3), device=dev, generator=g) * 20 - 10
            pc = torch.rand((bsz, v2, 3), device=dev, generator=g) * 20 - 10
            dpc = torch.sqrt(pairwise_sqdist(pc, pc))
            w = (torch.rand((bsz, p), device=dev, generator=g) < 0.7).float()
            if bsz > 1:
                w[1] = 0.0                      # a frame without live rows
            o1 = K.consistency_sum_rank_major(cad, dpc, w, v2)
            o2 = K.consistency_sum_rank_major(cad, dpc, w, v2)
            ref = K.consistency_sum_rank_major_plain(cad, dpc, w, v2)
            err = (o1 - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            if not (torch.equal(o1, o2) and err <= tol
                    and not o1[w.sum(-1) == 0].any()):
                raise AssertionError(f"rank-major k={k} {label}: error "
                                     f"{err} > {tol}, launches differ, or "
                                     "a dead frame non-zero")
            b_ms, by = bound(4 * bsz * (3 * p + p + v2 * v2 + p),
                             12 * float(w.sum().item()) * p)
            # the library call's (P, P) tables, as many frames at a time
            # as fit in ~8 GB
            per = max(1, int(8e9 // (3 * 4 * p * p)))

            def library():
                for f in range(0, bsz, per):
                    da = torch.cdist(cad[f:f + per], cad[f:f + per])
                    torch.einsum("bi,bij->bj", w[f:f + per], (
                        da - dpc[f:f + per].repeat(1, k, k)).abs_())

            row[label] = dict(
                max_abs_err=err, tol=tol,
                ms=graph_ms(lambda: K.consistency_sum_rank_major(
                    cad, dpc, w, v2)),
                plain_ms=cuda_ms(lambda: K.consistency_sum_rank_major_plain(
                    cad, dpc, w, v2), 1),
                library_ms=cuda_ms(library, 1), bound_ms=b_ms, bound_by=by,
                segments=rank_major_segments_on(dev, bsz, v2, k),
                rank_chunks=rank_major_chunks(k))
            del cad, pc, dpc, w, o1, o2, ref
        out[f"k={k}"] = row
    return out


# the refiner's two calls of a B = 8 train step: (queries, keys, valid
# queries, valid keys) of the kernel table's timing inputs, and the
# training frames' masks (CAD 5002 of 5120; PC 622 and 2000 of 2048,
# alternating frames)
FLASH_BWD_CALLS = ((5120, 2048, [5000], [2000]), (2048, 5120, [2000], [5000]))
FLASH_BWD_TRAIN = ((5120, 2048, [5002], [622, 2000]),
                   (2048, 5120, [622, 2000], [5002]))
# TF32 tensor cores, dense (NVIDIA data sheet, H100 SXM)
PEAK_TF32_FLOPS = 495e12


def flash_backward_case(name, dev, g, n, m, n_valid, m_valid,
                        keyless=True, segments=None, dim=16,
                        heads=2) -> tuple:
    """The backward kernel at B = 8 against autograd through the plain
    version: q, k, v random, the first n_valid / m_valid queries / keys
    of each frame valid (lists cycle over frames), dout 0 on the padded
    queries (as after merge * q_valid), frame 3 without keys if
    `keyless`. dq, dk, dv and the forward's lse within 1e-4 * max|ref| +
    1e-6 (f32 sums over <= 5120 terms in another order, the
    probabilities rebuilt from L, and 3xTF32 products: ~2^-20 relative
    per operand); masked keys get dk = dv = 0 exactly, the key-less frame
    dq = 0 and lse = -inf; two launches bit-identical. `segments` = (Gq,
    Gkv) forces the split (else the wrapper's plan). Returns the case's
    numbers, a closure that runs the public wrapper, and the inputs.
    `dim` and `heads` pick the kernel instance (16 x 2: the default
    refiner's)."""
    from pose6d_tpu_torch.ops import kernels as K
    from pose6d_tpu_torch.ops.kernels.attention import (
        _backward_kernel, _forward_kernel, flash_backward_segments_on,
        kernel_instance)
    B, scale = TRAIN_BATCH, dim ** -0.5
    q, kk, vv = (torch.randn((B, s, dim, heads), device=dev, generator=g)
                 for s in (n, m, m))
    q_valid = prefix_mask(B, n, n_valid, dev)
    kv = prefix_mask(B, m, m_valid, dev)
    if keyless:
        kv[3] = False
    dout = torch.randn((B, n, dim, heads), device=dev, generator=g) \
        * q_valid[..., None, None]
    out, lse = _forward_kernel(q, kk, vv, kv, scale, True)
    got = _backward_kernel(q, kk, vv, kv, scale, out, lse, dout, segments)
    again = _backward_kernel(q, kk, vv, kv, scale, out, lse, dout, segments)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash backward {name}: launches differ")
    want = K.flash_cross_attention_backward_plain(q, kk, vv, kv, scale, dout)
    s = torch.einsum("bndh,bmdh->bnhm", q, kk) * scale
    lse_ref = torch.logsumexp(s.masked_fill(~kv[:, None, None], -math.inf),
                              -1)
    has_key = kv.any(-1)[:, None, None]     # L = -inf checked below
    err, tols = 0.0, []
    for a, b in [(lse.where(has_key, 0.0), lse_ref.where(has_key, 0.0)),
                 *zip(got, want)]:
        tol = 1e-4 * b.abs().max().item() + 1e-6
        e = (a - b).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"flash backward {name}: error {e} > {tol}")
        err, tols = max(err, e), tols + [tol]
    dead = ~kv.any(-1)
    if not (bool((lse[dead] == -math.inf).all()) and not got[0][dead].any()
            and not got[1][~kv].any() and not got[2][~kv].any()):
        raise AssertionError(f"flash backward {name}: masked keys or the "
                             "key-less frame got a gradient")
    # valid (query, key) pairs x heads of the frames that have keys
    pairs = heads * float((q_valid.sum(-1) * kv.sum(-1)).sum().item())
    fb, fh = kernel_instance(B, dim, heads)
    return dict(max_abs_err=err, tol=max(tols), pairs=pairs,
                segments=list(segments or flash_backward_segments_on(
                    dev, fb, n, m, fh, dim))), \
        (lambda: K.flash_cross_attention_backward(q, kk, vv, kv, scale, out,
                                                  lse, dout)), \
        (q, kk, vv, kv, dout)


def backward_bounds(B, n, m, pairs, dim=16, heads=2) -> dict:
    """Least time for the backward on these inputs: q, k, v, out, dout, L
    read and dq, dk, dv written once; 5 products of `dim` per valid
    (query, key, head) (s, dout . v, and the dq, dk, dv updates). bound_ms
    counts them in f32 at the CUDA cores' rate; bound_tc_ms in 3xTF32 (3 x
    the flops) at the TF32 tensor-core rate, plus exp(s - L) and dS = P
    (dP - D) (4 operations) at the f32 rate."""
    tok = dim * heads
    n_bytes = 4 * B * tok * (4 * n + 4 * m) + 4 * B * n * heads + B * m
    b_ms, by = bound(n_bytes, pairs * 5 * dim * 2)
    tc = pairs * 5 * dim * 2 * 3 / PEAK_TF32_FLOPS + pairs * 4 / PEAK_F32_FLOPS
    return dict(bound_ms=b_ms, bound_by=by,
                bound_tc_ms=1e3 * max(n_bytes / PEAK_BYTES, tc))


def mma_tf32_tflops(dev) -> float:
    """The TF32 rate of mma.sync.m16n8k8 that the card sustains
    (flash_cross_attention_bwd.cu mma_rate_kernel: 8 blocks of 4 warps
    per SM, each warp 8 independent products per step), in TFLOP/s."""
    from pose6d_tpu_torch.ops.kernels import _build
    lib = _build.library("flash_cross_attention_bwd.cu")
    blocks, iters = 8 * _build.sm_count(dev), 4096
    out = torch.zeros(blocks, device=dev)
    ms = cuda_ms(lambda: _build.check(lib.flash_cross_attention_bwd_mma_rate(
        blocks, iters, out.data_ptr(), _build.stream_ptr(dev)), "mma rate"),
        5, 2)
    return blocks * 4 * iters * 8 * 2 * 16 * 8 * 8 / (ms * 1e9)


def check_flash_backward(dev, g) -> dict:
    """dq, dk, dv of the hand-written backward against autograd through
    the plain version, at B = 8 in both directions of the refiner: on
    the kernel table's timing inputs (frame 3 without keys), on the
    training frames' masks, and unsplit (one segment each forced). Both
    sets timed by CUDA-graph replay (ms) and back-to-back from the host
    (call_ms); the plain version and autograd through SDPA beside."""
    from pose6d_tpu_torch.ops import kernels as K
    B = TRAIN_BATCH
    t = dict.fromkeys(("ms", "call_ms", "plain_ms", "library_ms",
                       "bound_ms", "bound_tc_ms"), 0.0)
    train_ms, cases, by = 0.0, {}, ""
    for n, m, n_valid, m_valid in FLASH_BWD_CALLS:
        res, kern, (q, kk, vv, kv, dout) = flash_backward_case(
            f"{n}x{m}", dev, g, n, m, n_valid, m_valid)
        bnd = backward_bounds(B, n, m, res["pairs"])
        res.update(ms=graph_ms(kern), call_ms=cuda_ms(kern, 10), **bnd)
        cases[f"{n}x{m}, {n_valid} / {m_valid} valid, frame 3 key-less"] = res
        t["plain_ms"] += cuda_ms(lambda: K.flash_cross_attention_backward_plain(
            q, kk, vv, kv, 16 ** -0.5, dout), 2)
        qs, ks, vs = (x.permute(0, 3, 1, 2).contiguous().requires_grad_()
                      for x in (q, kk, vv))
        lo = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=kv[:, None, None, :])
        do = dout.permute(0, 3, 1, 2).contiguous()
        t["library_ms"] += cuda_ms(lambda: torch.autograd.grad(
            lo, (qs, ks, vs), do, retain_graph=True), 5)
        for key in ("ms", "call_ms", "bound_ms", "bound_tc_ms"):
            t[key] += res[key]
        by = bnd["bound_by"]
    for n, m, n_valid, m_valid in FLASH_BWD_TRAIN:
        res, kern, _ = flash_backward_case(
            f"train {n}x{m}", dev, g, n, m, n_valid, m_valid, keyless=False)
        res.update(ms=graph_ms(kern), **backward_bounds(B, n, m,
                                                       res["pairs"]))
        train_ms += res["ms"]
        cases[f"training masks {n}x{m}, {n_valid} / {m_valid} valid"] = res
    n, m, n_valid, m_valid = FLASH_BWD_CALLS[1]
    cases[f"{n}x{m}, one segment each"] = flash_backward_case(
        "unsplit", dev, g, n, m, n_valid, m_valid, segments=(1, 1))[0]
    for label, res in cases.items():
        emit("kernel_case", name="flash_cross_attention_backward",
             case=f"B=8 {label}", **res)
    return dict(
        route="cuda", source="pose6d_tpu_torch/csrc/flash_cross_attention_bwd.cu",
        replaces="pose6d_tpu/ops/pallas/attention.py:30 (the library "
                 "flash attention's dq and dkv pallas_calls)",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        tol="1e-4 * max|ref| + 1e-6 per tensor (max "
            f"{max(c['tol'] for c in cases.values()):.3g})",
        **t, bound_by=by, train_masks_ms=train_ms,
        mma_sync_tf32_tflops=mma_tf32_tflops(dev),
        shapes="q (8,5120,16,2) x kv (8,2048,16,2), 5000 / 2000 valid, + "
               "the reverse, frame 3 without keys; train_masks_ms: the "
               "training frames' masks",
        timing="ms: device time per call of both calls (graph replay); "
               "call_ms: back-to-back calls from the host")


def consistency_reference(ca, cb, w):
    """Per frame in float64 from direct differences: the sums, the
    scale sum_i w_i (da + db), and a bound on what the f32 expansion
    |x|^2 - 2xy + |y|^2 (the plain version, like the TPU kernel) can
    add to the sums: its error in d^2 is at most 8 eps (|x|^2 + |y|^2),
    which moves d = sqrt(d^2) by at most min(sqrt(that), that / d)."""
    ref, scale, expand = [], [], []
    for a, b, wf in zip(ca.double(), cb.double(), w.double()):
        da, db = (torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
                  for x in (a, b))
        bnd = torch.zeros_like(da)
        for x, d in ((a, da), (b, db)):
            n2 = (x * x).sum(-1)
            e = 8 * F32_EPS * (n2[:, None] + n2[None])
            bnd += torch.minimum(e.sqrt(), e / d.clamp_min(1e-30))
        ref.append(wf @ (da - db).abs())
        scale.append(wf @ (da + db))
        expand.append(wf @ bnd)
    return torch.stack(ref), torch.stack(scale), torch.stack(expand)


def consistency_inputs(dev, g, bsz: int, shared: bool = False):
    """PC-major consistency inputs, P = 10240: CAD-side endpoints in the
    model frame (+-10 cm), PC-side ones ~100 cm down the optical axis,
    half of them consistent, 70 % of the rows live at random. `shared`:
    as on the PC-major filter's real inputs, cb comes in groups of 5
    equal points (the 5 candidates of one PC point; pair index = PC
    point * 5 + rank), the CAD endpoints are drawn from 1024 points
    (nearby PC points share candidates), and the live rows are the
    first 2000 or 622 PC points' groups."""
    B, P = bsz, 5 * 2048
    rot = torch.linalg.qr(torch.randn((3, 3), device=dev, generator=g))[0]
    shift = torch.tensor([0.0, 0.0, 100.0], device=dev)
    if not shared:
        ca = torch.rand((B, P, 3), device=dev, generator=g) * 20 - 10
        cb = ca @ rot.T + shift
        noise = torch.rand((B, P, 3), device=dev, generator=g) * 20 - 10
        cb = torch.where(torch.rand((B, P, 1), device=dev, generator=g) < 0.5,
                         cb + 0.05 * noise, cb + noise)
        w = (torch.rand((B, P), device=dev, generator=g) < 0.7).float()
        return ca, cb, w
    cad = torch.rand((B, 1024, 3), device=dev, generator=g) * 20 - 10
    # PC point i sees CAD point i mod 1024 (within 1 cm); its rank-0
    # candidate is that point, the other four are drawn at random
    own = torch.arange(2048, device=dev) % 1024
    pc = cad[:, own] @ rot.T + shift \
        + torch.rand((B, 2048, 3), device=dev, generator=g) * 2 - 1
    pick = torch.randint(0, 1024, (B, 2048, 5), device=dev, generator=g)
    pick[..., 0] = own
    ca = torch.gather(cad, 1, pick.reshape(B, P, 1).expand(-1, -1, 3))
    cb = pc.repeat_interleave(5, dim=1)
    w = prefix_mask(B, 2048, [2000, 622], dev).float().repeat_interleave(
        5, dim=1)
    return ca, cb, w


def consistency_case(name, ca, cb, w) -> dict:
    """Two launches (bit-identical) against float64 from direct
    differences (2e-5 of sum w (da + db): f32 rounding of each distance
    and of sums of ~7000 terms) and against the plain version (the f32
    expansion's bound on top of that)."""
    from pose6d_tpu_torch.ops import kernels as K
    from pose6d_tpu_torch.ops.kernels.consistency import \
        consistency_segments_on
    out = K.masked_consistency_sum(ca, cb, w)
    if not torch.equal(out, K.masked_consistency_sum(ca, cb, w)):
        raise AssertionError(f"masked_consistency_sum {name}: launches "
                             "differ")
    plain = K.masked_consistency_sum_plain(ca, cb, w)
    ref, scale, expand = consistency_reference(ca, cb, w)
    err_direct = (out.double() - ref).abs()
    if not bool((err_direct <= 2e-5 * scale).all()):
        raise AssertionError(f"masked_consistency_sum {name} disagrees with "
                             "float64")
    err = (out - plain).abs()
    tol = expand + 4e-5 * scale
    if not bool((err.double() <= tol).all()):
        raise AssertionError(f"masked_consistency_sum {name} disagrees with "
                             "its plain version beyond the expansion's error")
    return dict(max_abs_err=err.max().item(),
                max_rel_err_vs_float64=(err_direct / ref.clamp_min(1e-30)
                                        ).max().item(),
                max_tol_margin=(err.double() / tol).max().item(),
                segments=consistency_segments_on(w.device, *w.shape))


def check_masked_consistency(dev, g) -> dict:
    """The PC-major consistency sums at B = 16 and B = 1, P = 10240, on
    random endpoints with 70 % of the rows live and, at B = 16, on
    endpoints shared as on real frames; each case held to float64 and
    to the plain version, two launches bit-identical, timed by CUDA-graph
    replay (ms; B = 16 also back-to-back from the host, call_ms)."""
    from pose6d_tpu_torch.ops import kernels as K
    P = 5 * 2048
    rows, cases = {}, {}
    for label, bsz in (("b16", BATCH), ("b1", 1)):
        ca, cb, w = consistency_inputs(dev, g, bsz)
        res = consistency_case(label, ca, cb, w)
        # per live (row, column) pair: 6 differences, 2 x (mul + 2 FMA),
        # 2 sqrt, a difference, an abs and one FMA: 22 operations
        b_ms, by = bound(4 * bsz * P * (3 + 3 + 1 + 1),
                         22 * float(w.sum().item()) * P)

        def kern():
            return K.masked_consistency_sum(ca, cb, w)

        def library():
            da = torch.cdist(ca, ca)
            db = torch.cdist(cb, cb)
            return torch.einsum("bi,bij->bj", w, (da - db).abs_())
        rows[label] = cases[f"{label}, 70 % live"] = dict(
            res, ms=graph_ms(kern), call_ms=cuda_ms(kern, 10),
            plain_ms=cuda_ms(lambda: K.masked_consistency_sum_plain(ca, cb,
                                                                    w), 2),
            bound_ms=b_ms, bound_by=by, library_ms=cuda_ms(library, 2))
    ca, cb, w = consistency_inputs(dev, g, BATCH, shared=True)
    cases["B=16, cb in groups of 5, CAD from 1024 points, live prefix "
          "[2000, 622]"] = dict(
        consistency_case("shared endpoints", ca, cb, w),
        ms=graph_ms(lambda: K.masked_consistency_sum(ca, cb, w)))
    for label, res in cases.items():
        emit("kernel_case", name="masked_consistency_sum", case=label, **res)
    main = rows["b16"]
    return dict(
        route="cuda", source="pose6d_tpu_torch/csrc/masked_consistency_sum.cu",
        replaces="pose6d_tpu/ops/pallas/consistency.py:136",
        tol="float64: 2e-5 * sum w (da + db); plain: the f32 expansion's "
            "bound (min(sqrt(e), e/d) per term, e = 8 eps (|x|^2+|y|^2)) "
            "+ 4e-5 * sum w (da + db)",
        **{k: main[k] for k in ("max_abs_err", "max_rel_err_vs_float64",
                                "max_tol_margin", "segments", "ms",
                                "call_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        b1=rows["b1"],
        shapes="ca, cb (16,10240,3), w (16,10240), 70 % live; b1: the same "
               "at B = 1",
        timing="ms: device time per call (graph replay); call_ms: "
               "back-to-back calls from the host")


def sass_loop_counts() -> dict:
    """Instructions that the sm_90a builds issue in the inner loops of the
    kernels redesigned for issue rate, read with cuobjdump -sass: the two
    consistency kernels' work per row entry (from the weight test
    through the square roots' range branch, plus the block that
    accumulates w |da - d|: 10 pairs rank-major, 8 PC-major), the flash
    forward's per step of 8 keys x 4 (query, head) rows (the loop from
    its chunk test to its back branch), and the flash backward's per
    chunk of 8 walked rows x 16 rows x 2 heads (the loop around the
    tensor-core products, HMMA counted apart). "not measured" without
    cuobjdump."""
    import re
    import shutil
    from pose6d_tpu_torch.ops.kernels import _build
    from pose6d_tpu_torch.ops.kernels.consistency import PCM_COL_TILE
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def function(source, name):
        sass = subprocess.run([tool, "-sass", str(_build._target(source))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        body = next(f for f in sass.split("Function : ")[1:]
                    if name in f.split("\n")[0])
        return [(int(a, 16), t) for a, t in re.findall(
            r"/\*([0-9a-f]{4,5})\*/\s+([^;]*);", body)]

    def branch_after(ins, i):
        while "BRA" not in ins[i][1]:
            i += 1
        return i

    def row_entry(ins):
        first = next(i for i, (_, t) in enumerate(ins) if "MUFU.RSQ" in t)
        lo = max(i for i in range(first) if "FSETP.NEU" in ins[i][1]) - 1
        hi = branch_after(ins, first)
        target = int(re.search(r"0x([0-9a-f]+)", ins[hi][1]).group(1), 16)
        j = next(i for i, (a, _) in enumerate(ins) if a == target)
        k = next(i for i in range(j + 1, len(ins))
                 if ins[i][1].startswith(("LDS", "BSYNC")))
        return hi - lo + 1 + k - j + 1

    def mma_loop(ins):
        """(instructions, HMMA) from the branch before the first HMMA to
        the branch after the last."""
        hm = [i for i, (_, t) in enumerate(ins) if t.startswith("HMMA")]
        lo = max(i for i in range(hm[0]) if "BRA" in ins[i][1]) + 1
        hi = branch_after(ins, hm[-1])
        return hi - lo + 1, sum(t.startswith("HMMA") for _, t in ins[lo:hi])

    try:
        # the k = 5 instance (the serve path's, its row loop unrolled)
        rm = row_entry(function("consistency_rank_major.cu",
                                "consistency_rm_kernelILi5ELi5E"))
        pcm = row_entry(function("masked_consistency_sum.cu",
                                 "masked_consistency_kernel"))
        ins = function("flash_cross_attention.cu", "flash_fwd_kernelILi2")
        lds = [i for i, (_, t) in enumerate(ins) if t.startswith("LDS.128")]
        lo = max(i for i in range(lds[0]) if "BRA" in ins[i][1]) + 1
        step = branch_after(ins, lds[-1]) - lo + 1
        bwd = {name: mma_loop(function("flash_cross_attention_bwd.cu",
                                       f"flash_bwd_{name}_kernelILi2"))
               for name in ("dq", "dkv")}
    except (OSError, subprocess.SubprocessError, StopIteration,
            ValueError, AttributeError, IndexError) as e:
        return {"sass": f"not measured ({type(e).__name__})"}
    # a chunk is 8 x 16 (query, key) x 2 heads with 3 mma per product and
    # k-step: 18 HMMA per head in the dq kernel (s, dout . v over 2
    # k-steps, 2 n-tiles of dq), 24 in the dkv kernel (dk and dv too).
    # Lane-instructions per (query, key, head) are warp-instructions per
    # chunk x 32 / 256.
    per = {}
    for name, (n, h) in bwd.items():
        chunks = h / (36 if name == "dq" else 48)
        per[f"flash_bwd_{name}_per_chunk"] = n / chunks
        per[f"flash_bwd_{name}_hmma_per_chunk"] = h / chunks
    return {"rank_major_per_row_entry": rm, "rank_major_per_pair": rm / 10,
            "pc_major_per_row_entry": pcm,
            "pc_major_per_pair": pcm / (PCM_COL_TILE // 32),
            "flash_per_step": step, "flash_per_query_head_key": step / 32,
            **per, "flash_bwd_lane_instructions_per_query_key_head":
                (per["flash_bwd_dq_per_chunk"]
                 + per["flash_bwd_dkv_per_chunk"]) / 8}


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
    """The angle between two rotations, from |Ra - Rb|_F = sqrt(8)
    sin(angle / 2) in float64 (exact 0 for equal matrices; the arccos of
    the trace cannot resolve angles below ~0.03 deg in f32)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, d / np.sqrt(8.0)))))


# the online frames: (random_shape seed, degraded?). Seed 38 at its pose
# covers 16675 pixels after the mask's erosion, more than the 16384
# points the backprojection keeps; seed 3's frame gets sensor noise and
# holes
ONLINE_FRAMES = ((38, False), (3, True))
ONLINE_DRAW_BLOCKS = 131072 // 512      # RANSAC blocks of a request
# masked_argmin_cdist launches of one online request: base ICP 30 + 1,
# the flip bank 4 coarse + 1 fine + 1 final, the winner 5 + 5 + 1
ONLINE_LAUNCHES = {"flash_cross_attention": 2,
                   "consistency_sum_rank_major": 3,
                   "masked_topk_cdist": 1, "masked_argmin_cdist": 48}


def render_online_frames() -> list:
    """Two 640 x 480 depth frames of random_shape meshes (4610 vertices,
    padded to the CAD width 5120) at poses drawn as bench.py draws them,
    with the LM intrinsics: uint16 mm depth, depth_scale 1, mask = depth
    > 0; the second frame degraded (1 mm noise, 2 % holes). CAD operators
    from point_cloud_operators(verts * 0.1)."""
    import warnings
    from scipy.spatial.transform import Rotation

    from pose6d_tpu_torch.data.shapes import random_shape
    from pose6d_tpu_torch.data.synth import degrade_depth, rasterize_depth
    from pose6d_tpu_torch.ops.geometry import erode_mask
    from pose6d_tpu_torch.spectral.operators import point_cloud_operators
    frames = []
    for seed, degraded in ONLINE_FRAMES:
        verts, faces = random_shape(seed)
        rng = np.random.default_rng(seed * 1000)
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.9).as_matrix()
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(900, 1200)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            depth = rasterize_depth(verts, faces, R, t)
        if degraded:
            depth = degrade_depth(depth, rng, noise_mm=1.0, hole_frac=0.02)
        depth = np.clip(depth, 0, 65535).astype(np.uint16)
        mask = depth > 0
        t0 = time.time()
        cad_ops = point_cloud_operators(verts * 0.1)
        frames.append({
            "obj": seed, "degraded": degraded, "depth": depth, "mask": mask,
            "R_gt": R, "t_gt": t * 0.1, "cad_ops": cad_ops,
            "ops_s": time.time() - t0,
            "eroded_pixels": int(erode_mask(torch.as_tensor(mask)).sum()),
            "diam": float(np.linalg.norm(cad_ops["xyz"].max(0)
                                         - cad_ops["xyz"].min(0)))})
    if max(f["eroded_pixels"] for f in frames) <= 16384:
        raise AssertionError("no online frame exceeds the 16384 points that "
                             "backprojection keeps")
    return frames


def online_stages(pred, frame, draws, timed: bool) -> dict:
    """One online request's stages, as Predictor.predict runs them, on
    pred's device: backprojection, outlier mask, FPS, graph Laplacian,
    LOBPCG, model and pose (filter, RANSAC with `draws`, ICP), flip
    disambiguation. Returns the intermediates (on the CPU) and, when
    `timed` (card only), CUDA-event ms per stage with the device
    synchronised at each stage's end."""
    from pose6d_tpu_torch.api import MAX_RAW, pose_from_operators
    from pose6d_tpu_torch.data.synth import default_intrinsics
    from pose6d_tpu_torch.ops import geometry, sampling
    from pose6d_tpu_torch.solvers.multistart import disambiguate_pose_depth
    from pose6d_tpu_torch.spectral import device_lbo
    dev = pred.device
    ms, marks = {}, []

    def mark(name):
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            torch.cuda.synchronize()
            marks.append((name, ev))

    depth = torch.as_tensor(frame["depth"].astype(np.float32),
                            device=dev)[None]
    K = torch.as_tensor(default_intrinsics(), dtype=torch.float32,
                        device=dev)[None]
    mask = torch.as_tensor(frame["mask"], device=dev)[None]
    obj = frame["obj"]
    cad = {k: v[None] for k, v in pred.cad_bank[obj].items()}
    diam = torch.tensor([pred._diam[obj]], device=dev)
    with torch.inference_mode():
        mark("start")
        pts, valid = geometry.backproject_depth(depth, K, 1000.0, mask,
                                                max_points=MAX_RAW)
        mark("backproject")
        keep = geometry.statistical_outlier_mask(pts, valid)
        mark("outlier_mask")
        idx, sel = sampling.farthest_point_sample(pts, keep, pred.max_pc)
        pc = torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))
        pc = torch.where(sel[..., None], pc, 0.0)
        pad = pred.v_pc - pred.max_pc
        pc = torch.nn.functional.pad(pc, (0, 0, 0, pad))
        pcv = torch.nn.functional.pad(sel, (0, pad))
        mark("fps")
        L, mass = device_lbo.graph_laplacian(pc, pcv)
        mark("laplacian")
        evals, evecs, iters = device_lbo.lobpcg_smallest(
            L, mass, pcv, k_eig=pred.model.cfg.k_eig,
            iters=pred._lobpcg_iters)
        mark("lobpcg")
        ops = {"xyz": pc, "mass": mass, "evals": evals, "evecs": evecs,
               "valid": pcv}
        out = pose_from_operators(pred.model, cad, ops, diam,
                                  n_hypotheses=pred._rh,
                                  icp_iters=pred._icp_iters,
                                  uniforms=torch.as_tensor(draws,
                                                           device=dev)[None])
        mark("model_and_pose")
        fix = disambiguate_pose_depth(
            cad["xyz"], cad["valid"], pc, pcv, out["R"], out["t"], diam, K,
            depth * 0.1, mask, sym_rots=pred._sym_rots[obj][None])
        mark("disambiguation")
    on_device = [x.device.type for x in (pts, keep, idx, L, evals, evecs,
                                         out["R"], fix["R"])]
    if dev.type == "cuda" and set(on_device) != {"cuda"}:
        raise AssertionError(f"an online stage left the card: {on_device}")
    for (_, a), (name, b) in zip(marks[:-1], marks[1:]):
        ms[name] = a.elapsed_time(b)
    return {"pts": pts[0].cpu(), "valid": valid[0].cpu(),
            "keep": keep[0].cpu(), "idx": idx[0].cpu(),
            "sel": sel[0].cpu(), "evals": evals[0].cpu(),
            "lobpcg_iters": iters[0], "R": fix["R"][0].cpu().numpy(),
            "t": fix["t"][0].cpu().numpy(),
            "hypothesis": int(fix["hypothesis"][0]),
            "base_R": out["R"][0].cpu().numpy(),
            "ops": {k: v for k, v in ops.items()}, "ms": ms}


def cpu_copy(model):
    """The model's weights in a new module on the CPU."""
    cpu_model = type(model)(model.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    return cpu_model.eval()


def pose_errors(frame, R, t, bank) -> dict:
    from pose6d_tpu_torch.ops.symmetry import sym_rotation_error_deg
    return {"rot_err_deg": rot_deg(R, frame["R_gt"]),
            "rot_err_mod_sym_deg": sym_rotation_error_deg(
                frame["R_gt"], R, bank),
            "t_err_frac_diam": float(np.linalg.norm(t - frame["t_gt"])
                                     / frame["diam"])}


def online_request(frames, model, gpu_line: str):
    """Predictor(mode="online", device="cuda").predict on both frames:
    round 0 warms up, round 1 is timed (host clock around a synchronised
    call). Then each frame's stages alone, CUDA events. Returns the
    predictor, the draws, the card's results and stage outputs, and the
    launch counts of the predict() calls."""
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.data.synth import default_intrinsics
    from pose6d_tpu_torch.ops.kernels import reset_launches
    bank = {f["obj"]: f["cad_ops"] for f in frames}
    rng = np.random.default_rng(1)
    draws = {f["obj"]: rng.random((ONLINE_DRAW_BLOCKS, 512, 3),
                                  dtype=np.float32) for f in frames}
    t0 = time.perf_counter()
    pred = Predictor(model, bank, mode="online", device="cuda")
    init_s = time.perf_counter() - t0
    K = default_intrinsics()
    reset_launches()
    results = {}
    for rnd in range(2):
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred.predict(f["depth"], K, 1.0, [f["mask"]], [f["obj"]],
                               uniforms=[draws[f["obj"]]])[0]
            ms = 1e3 * (time.perf_counter() - t0)
            results[f["obj"]] = dict(out, ms=ms)
            if rnd == 1:
                emit("online_request", obj=f["obj"], degraded=f["degraded"],
                     round=rnd, ms=ms, gpu=gpu_line,
                     flip_hypothesis=int(out["flip_hypothesis"]),
                     n_inliers=int(out["n_inliers"]),
                     **pose_errors(f, out["R"], out["t"],
                                   pred._sym_rots[f["obj"]].cpu().numpy()))
    counts = launched(PATH_KERNELS["online"], "online")
    per_frame = {k: counts[k] / (2 * len(frames)) for k in ONLINE_LAUNCHES}
    emit("online_launches", per_frame=per_frame, expected=ONLINE_LAUNCHES,
         requests=2 * len(frames),
         note="argmin: base ICP 30 iterations + 1 final; flip bank 4 coarse "
              "+ 1 fine + 1 final (one launch for all 6 hypotheses); "
              "winner 5 coarse + 5 fine + 1 final")
    if per_frame != {k: float(v) for k, v in ONLINE_LAUNCHES.items()}:
        raise AssertionError(f"online launches per frame {per_frame}, "
                             f"expected {ONLINE_LAUNCHES}")
    stages = {}
    for f in frames:
        online_stages(pred, f, draws[f["obj"]], timed=True)   # warm
        st = online_stages(pred, f, draws[f["obj"]], timed=True)
        stages[f["obj"]] = st
        out = results[f["obj"]]
        if not (rot_deg(st["R"], out["R"]) <= 0.1 and np.linalg.norm(
                st["t"] - out["t"]) <= 1e-3 * f["diam"]):
            raise AssertionError("online_stages does not reproduce predict()")
        emit("online_stages", obj=f["obj"], gpu=gpu_line,
             timing="CUDA-event ms per stage, device synchronised at each "
                    "stage's end (host gaps included)",
             ms=st["ms"], total_ms=sum(st["ms"].values()),
             raw_points=int(st["valid"].sum()),
             kept_points=int(st["keep"].sum()),
             eroded_mask_pixels=f["eroded_pixels"],
             sampled_points=int(st["sel"].sum()),
             lobpcg_iterations=st["lobpcg_iters"],
             flip_hypothesis=st["hypothesis"],
             stages_vs_predict_deg=rot_deg(st["R"], results[f["obj"]]["R"]),
             init_s=init_s)
    return pred, draws, results, stages, counts


def covering_radius(pts, keep, idx) -> float:
    """The largest distance from a kept point to its nearest pick, f64."""
    p = pts[keep].double()
    sel = pts[idx].double()
    return float(torch.cdist(p, sel).min(-1).values.max())


def online_cpu_agreement(frames, model, pred, draws, results, stages):
    """The same requests through the port on the CPU (predict()'s stages,
    online_stages, which on the card give predict()'s pose), with the
    same LOBPCG start block and RANSAC draws: backprojection exact,
    outlier keep masks equal, FPS picks counted (when any differ, the
    covering radii within 1 %), the first 30 eigenvalues within 1e-3
    relative (the null mode within 1e-3 of the first nonzero one), the
    card's predict() pose within 1 deg and 1 % of the diameter."""
    from pose6d_tpu_torch.api import Predictor
    bank = {f["obj"]: f["cad_ops"] for f in frames}
    cpu = Predictor(cpu_copy(model), bank, mode="online", device="cpu")
    for f in frames:
        t0 = time.perf_counter()
        st = online_stages(cpu, f, draws[f["obj"]], timed=False)
        cpu_s = time.perf_counter() - t0
        gpu, out = stages[f["obj"]], results[f["obj"]]
        ref = {"R": st["R"], "t": st["t"], "flip_hypothesis": st["hypothesis"]}
        cloud, cloud_ok = cloud_stage_agreement(gpu, st)
        dr = rot_deg(out["R"], ref["R"])
        dt = float(np.linalg.norm(out["t"] - ref["t"]) / f["diam"])
        emit("online_cpu_agreement", obj=f["obj"], **cloud,
             lobpcg_iterations=[gpu["lobpcg_iters"], st["lobpcg_iters"]],
             rot_deg=dr, t_frac_diam=dt,
             flip_hypothesis=[int(out["flip_hypothesis"]),
                              int(ref["flip_hypothesis"])],
             cpu_s=cpu_s,
             tol="points exact, keep 0 differing, covering radius 1 %, "
                 "evals 1e-3 rel, pose 1 deg and 1 % diam")
        if not (cloud_ok and dr <= 1.0 and dt <= 0.01):
            raise AssertionError(f"online card and CPU disagree on obj "
                                 f"{f['obj']}")


def cloud_stage_agreement(gpu, st) -> tuple:
    """The online cloud stage of one request, card (`gpu`) against CPU
    (`st`), both online_stages outputs: (numbers, ok). ok: backprojected
    points exact, outlier keep masks equal, FPS picks equal or their
    covering radii within 1 %, the first 30 eigenvalues within 1e-3
    relative (the null mode within 1e-3 of the first nonzero one)."""
    exact = torch.equal(gpu["pts"], st["pts"]) and \
        torch.equal(gpu["valid"], st["valid"])
    keep_diff = int((gpu["keep"] != st["keep"]).sum())
    pick_diff = int((gpu["idx"] != st["idx"]).sum())
    radii = [covering_radius(st["pts"], st["keep"], s["idx"])
             for s in (gpu, st)]
    e_g, e_c = gpu["evals"][:30].double(), st["evals"][:30].double()
    scale = e_c.abs().clamp_min(float(e_c[1]))
    eval_rel = float(((e_g - e_c).abs() / scale).max())
    ok = (exact and keep_diff == 0 and eval_rel <= 1e-3
          and (pick_diff == 0 or abs(radii[0] - radii[1]) <= 0.01 * radii[1]))
    return dict(points_exact=exact, keep_mask_differing=keep_diff,
                fps_picks_differing=pick_diff, covering_radius_cm=radii,
                eval_max_rel_diff_first30=eval_rel), ok


# frames of the B = 16 disambiguation batch that the CPU reruns: half,
# which keeps the script's CPU side inside its time budget
CPU_FRAMES = 8


def disambiguation_batch(frames, model, pred, stages, dev, gpu_line: str):
    """B = 16 (8 copies of each frame, own RANSAC draws each) through
    candidate_select_pose -> disambiguate_pose_depth, bench.py's recipe
    after its data layer (4096 hypotheses, 30 ICP iterations at coarse
    stride 4, the flip bank), on the operators of the card's online
    stage; CUDA-event ms per batch and per stage. Held to the port's CPU
    run of its first CPU_FRAMES frames (in chunks of 4; each online frame
    with four draws): pose within 1 deg and 1 % of the diameter, per
    frame."""
    from pose6d_tpu_torch.data.synth import default_intrinsics
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from pose6d_tpu_torch.solvers.candidates import candidate_select_pose
    from pose6d_tpu_torch.solvers.multistart import disambiguate_pose_depth
    picks = [frames[i % len(frames)] for i in range(BATCH)]

    def batch_on(d, sel):
        cad = {k: torch.stack([pred.cad_bank[picks[i]["obj"]][k]
                               for i in sel]).to(d)
               for k in ("xyz", "mass", "evals", "evecs", "valid")}
        pc = {k: torch.cat([stages[picks[i]["obj"]]["ops"][k]
                            for i in sel]).to(d)
              for k in ("xyz", "mass", "evals", "evecs", "valid")}
        n = len(sel)
        return dict(
            cad=cad, pc=pc,
            diam=torch.tensor([pred._diam[picks[i]["obj"]] for i in sel],
                              device=d),
            K=torch.as_tensor(default_intrinsics(), dtype=torch.float32,
                              device=d).expand(n, 3, 3),
            obs=torch.stack([torch.as_tensor(picks[i]["depth"].astype(
                np.float32) * 0.1) for i in sel]).to(d),
            mask=torch.stack([torch.as_tensor(picks[i]["mask"])
                              for i in sel]).to(d),
            rots=torch.stack([pred._sym_rots[picks[i]["obj"]]
                              for i in sel]).to(d),
            u=torch.as_tensor(draws16[sel]).to(d))

    draws16 = np.random.default_rng(2).random((BATCH, 8, 512, 3),
                                              dtype=np.float32)

    def run(b, m, events=None):
        with torch.inference_mode():
            sel = candidate_select_pose(
                m, b["cad"], b["pc"], b["diam"], n_fmap=m.cfg.n_fmap,
                ransac_hypotheses=4096, icp_iters=30, uniforms=b["u"])
            if events:
                events[1].record()
            fix = disambiguate_pose_depth(
                b["cad"]["xyz"], b["cad"]["valid"], b["pc"]["xyz"],
                b["pc"]["valid"], sel["R"], sel["t"], b["diam"], b["K"],
                b["obs"], b["mask"], sym_rots=b["rots"])
        return fix

    full = batch_on(dev, list(range(BATCH)))
    run(full, model)
    reps, stage = 3, {"candidate_select": 0.0, "disambiguation": 0.0}
    reset_launches()
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = run(full, model, ev)
        ev[2].record()
        torch.cuda.synchronize()
        stage["candidate_select"] += ev[0].elapsed_time(ev[1]) / reps
        stage["disambiguation"] += ev[1].elapsed_time(ev[2]) / reps
    counts = {k: v / reps for k, v in LAUNCHES.items()}
    R, t = out["R"].cpu().numpy(), out["t"].cpu().numpy()
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        raise AssertionError("non-finite pose in the disambiguation batch")
    cpu_model = cpu_copy(model)
    t0 = time.perf_counter()
    worst_r, worst_t, hyp_cpu = 0.0, 0.0, []
    for lo in range(0, CPU_FRAMES, 4):
        sel = list(range(lo, lo + 4))
        ref = run(batch_on(torch.device("cpu"), sel), cpu_model)
        hyp_cpu += ref["hypothesis"].tolist()
        for j, i in enumerate(sel):
            worst_r = max(worst_r, rot_deg(R[i], ref["R"][j].numpy()))
            worst_t = max(worst_t, float(np.linalg.norm(
                t[i] - ref["t"][j].numpy()) / picks[i]["diam"]))
    errs = [pose_errors(picks[i], R[i], t[i],
                        pred._sym_rots[picks[i]["obj"]].cpu().numpy())
            for i in range(BATCH)]
    emit("disambiguation_batch", batch=BATCH, gpu=gpu_line,
         frames="8 copies of each online frame, own RANSAC draws each",
         ransac_hypotheses=4096, icp_iters=30, coarse_stride=4,
         timing="CUDA-event ms, mean of 3 batches after a warm-up",
         ms_per_batch=sum(stage.values()), stage_ms=stage,
         frames_per_s=BATCH * 1e3 / sum(stage.values()),
         launches_per_batch=counts,
         flip_hypothesis=out["hypothesis"].tolist(),
         flip_hypothesis_cpu=hyp_cpu,
         rot_err_deg=[e["rot_err_deg"] for e in errs],
         rot_err_mod_sym_deg=[e["rot_err_mod_sym_deg"] for e in errs],
         cpu_agreement={"worst_rot_deg": worst_r,
                        "worst_t_frac_diam": worst_t,
                        "cpu_s": time.perf_counter() - t0,
                        "tol": "1 deg, 1 % diam"})
    if not (worst_r <= 1.0 and worst_t <= 0.01):
        raise AssertionError("disambiguation batch: card and CPU disagree")


def online_profile(pred, frame, draws, wall_ms: float) -> dict:
    """Device time of one online request (torch.profiler), its host
    syncs and the device items that took the most time. The busy share
    divides the device time by `wall_ms`, the same request's round-1
    wall from online_request: walls taken after a profiled window in the
    process (serve's and train's) read slow."""
    from torch.profiler import ProfilerActivity, profile

    from pose6d_tpu_torch.data.synth import default_intrinsics
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict(frame["depth"], default_intrinsics(), 1.0,
                     [frame["mask"]], [frame["obj"]],
                     uniforms=[draws[frame["obj"]]])
        torch.cuda.synchronize()
    syncs = {e.key: e.count for e in prof.key_averages()
             if e.key in SYNC_CALLS}
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    if device_us == 0:
        return {"device_busy_share": "not measured (no device time traced)"}
    return {"round1_wall_ms": wall_ms,
            "device_ms_per_request": device_us / 1e3,
            "device_busy_share": device_us / (1e3 * wall_ms),
            "top_device_ms_per_request": {
                e.key[:60]: e.self_device_time_total / 1e3 for e in rows[:10]},
            "device_launches_per_request": sum(e.count for e in rows),
            "host_sync_calls_per_request": syncs}


def serve(frames, model, dev):
    """Cached-mode requests through Predictor on the card, then the same
    frames and draws through the port on the CPU. Returns the launch
    counts of the card's run."""
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.ops.kernels import reset_launches
    bank = {f["obj"]: f["cad_ops"] for f in frames}
    rng = np.random.default_rng(0)
    draws = {f["obj"]: rng.random((256, 512, 3), dtype=np.float32)
             for f in frames}
    reset_launches()
    pred = Predictor(model, bank, mode="cached", device="cuda")
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
    counts = launched(PATH_KERNELS["serve"], "serve")
    emit("profile", obj=frames[0]["obj"], **profile_request(pred, frames[0]))
    emit("eigh_sync", gpu=gpu_name_and_limit(), **eigh_sync_probe(dev))

    cpu_pred = Predictor(cpu_copy(model), bank, mode="cached", device="cpu")
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
    syncs = {e.key: e.count / 3 for e in prof.key_averages()
             if e.key in SYNC_CALLS}
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
            "device_launches_per_request": sum(e.count for e in rows) / 3,
            "host_sync_calls_per_request": syncs}


# CUDA runtime calls that can make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def eigh_sync_probe(dev) -> dict:
    """Whether the batched 4x4 torch.linalg.eigh of Kabsch (one call per
    ICP iteration) makes the host wait for the device: the synchronising
    runtime calls of one call under torch.profiler, and the host time
    of one call queued behind three 4096^3 f32 products (a call that
    waits returns after them; a pure launch returns at once)."""
    from torch.profiler import ProfilerActivity, profile
    from pose6d_tpu_torch.solvers.kabsch import kabsch_umeyama
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((BATCH, 4, 4), device=dev, generator=g)
    sym = x + x.mT
    src = torch.randn((BATCH, 2048, 3), device=dev, generator=g)
    w = torch.ones((BATCH, 2048), device=dev)
    torch.linalg.eigh(sym)
    kabsch_umeyama(src, src, w)
    torch.cuda.synchronize()
    out = {}
    for label, fn in (("eigh", lambda: torch.linalg.eigh(sym)),
                      ("kabsch_umeyama", lambda: kabsch_umeyama(src, src, w))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key in SYNC_CALLS}
        big = torch.randn((4096, 4096), device=dev, generator=g)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            big @ big
        end.record()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        out[label] = {"sync_calls": calls, "host_ms_behind_queue": host_ms,
                      "queued_device_ms": start.elapsed_time(end)}
    return out


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


def stack_frames(frames, picks, dev):
    """The picked frames' operators padded and stacked on `dev`, and
    their CAD diameters."""
    from pose6d_tpu_torch.api import pad_operators
    from pose6d_tpu_torch.ops.masking import V_CAD, V_PC

    def stack(key, v):
        parts = [pad_operators(frames[i][key], v, dev) for i in picks]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    return (stack("cad_ops", V_CAD), stack("pc_ops", V_PC),
            torch.tensor([frames[i]["diam"] for i in picks], device=dev))


def pc_major_filter(frames, model, dev, gpu_line: str) -> dict:
    """One B = 16 spatial-filter call in the PC-major layout (the
    masked_consistency_sum kernel) against the rank-major one on the same
    input. Pair indices must be equal; survivor masks may differ only on
    pairs whose consistency mean, in either layout, lies within 0.1 % of
    a pruning threshold in some round (the two sum in other orders, and
    the PC-major kernel takes direct differences where the rank-major
    path reads an expanded distance table). Returns the PC-major call's
    launch counts."""
    from pose6d_tpu_torch.ops.kernels import reset_launches
    from pose6d_tpu_torch.solvers import spatial_filtering_fmap2pointmap
    from pose6d_tpu_torch.solvers.fmap2pointmap import TAUS
    cad, pc, diam = stack_frames(frames, [i % 2 for i in range(BATCH)], dev)
    nf = model.cfg.n_fmap
    with torch.inference_mode():
        C = model(cad, pc)["C"]
        args = (C, cad["evecs"][..., :nf], pc["evecs"][..., :nf], cad["xyz"],
                pc["xyz"], cad["valid"], pc["valid"], diam)
        runs, ms = {}, {}
        for rank_major in (False, True):
            spatial_filtering_fmap2pointmap(*args, rank_major=rank_major)
            if not rank_major:
                reset_launches()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runs[rank_major] = spatial_filtering_fmap2pointmap(
                *args, rank_major=rank_major, return_means=True)
            end.record()
            torch.cuda.synchronize()
            ms["rank_major" if rank_major else "pc_major"] = \
                start.elapsed_time(end)
            if not rank_major:
                counts = launched(PATH_KERNELS["pc_major_filter"],
                                  "pc_major_filter")
    (p_pc, v_pc, m_pc), (p_rm, v_rm, m_rm) = runs[False], runs[True]
    if not torch.equal(p_pc, p_rm):
        raise AssertionError("PC-major and rank-major pair indices differ")
    # round r's thresholds: TAUS[r] for the plain rounds, the last two
    # (tight, loose fallback) both for the final one
    rounds = [TAUS[r:r + 1] for r in range(len(TAUS) - 2)] + [TAUS[-2:]]
    near = torch.zeros_like(v_pc)
    for means in (m_pc, m_rm):
        for m, taus in zip(means, rounds):
            for tau in taus:
                thr = tau * diam[:, None]
                near |= (m - thr).abs() <= 1e-3 * thr
    flips = v_pc != v_rm
    if bool((flips & ~near).any()):
        raise AssertionError(f"{int((flips & ~near).sum())} survivor flips "
                             "away from every threshold")
    d0 = ((m_pc[0] - m_rm[0]).abs() / (TAUS[0] * diam[:, None]))
    emit("pc_major_filter", batch=BATCH, pairs=int(p_pc.shape[-1]),
         survivors_pc_major=int(v_pc.sum()), survivors_rank_major=int(
             v_rm.sum()), flips=int(flips.sum()), near_threshold=int(
             near.sum()), tol="0.1 % of the threshold",
         round0_max_mean_diff_frac_threshold=float(d0.max()),
         ms=ms, gpu=gpu_line, launches=counts)
    return counts


# the model variants of the config space (DPFMConfig keyword arguments);
# the wide ones are config/unseen_lm300_wide*.yaml's widths
WIDE = dict(n_feat=64, width=128, n_blocks=3, num_heads=4, gnn_dim=64,
            overlap_feat_dim=64)
VARIANTS = {
    "xyz_hks": dict(input_features="xyz_hks"),
    "hks_wks": dict(input_features="hks_wks", c_in=32),
    "wide_4_heads": WIDE,
    "double": dict(attention_type="double"),
    "double_wide": dict(attention_type="double", **WIDE),
    "ratio_0.5": dict(cross_sampling_ratio=0.5),
    "gradient_features": dict(with_gradient_features=True),
    "gradient_features_no_rotations": dict(with_gradient_features=True,
                                           with_gradient_rotations=False),
    "not_robust": dict(robust=False),
}
# the train step's variant: every switch that changes the backward at once
TRAIN_VARIANT = dict(attention_type="double", with_gradient_features=True,
                     cross_sampling_ratio=0.5)
# its gradient norm, card against CPU: 2e-3 relative. From a flax-like
# init its gradients are large (norm ~1e4) and the f32 step amplifies the
# summation order: the same step on the card with the plain attention
# (printed as plain_attention_norm) parts from the CPU by about as much
# as with the kernels (PERF.md); every leaf is held as train_check
# holds it
VARIANT_NORM_TOL = 2e-3
# card against the port's CPU on a full-width forward: features and
# overlaps within 1e-4 of their max, C within 1e-3 of max |C| (f32 sums
# of up to 5120 terms in another order; the regularized 30 x 30 solve
# amplifies them, as in tests/test_torch_model.py)
VARIANT_TOL = {"C": 1e-3, "other": 1e-4}


def gradient_ops(xyz) -> dict:
    """The gather-form tangent-gradient operators of a point cloud, as
    point_cloud_operators(build_gradients=True) builds them (its PCA
    frames, its 30-neighbour sets), without redoing its eigenbasis."""
    from scipy.spatial import cKDTree

    from pose6d_tpu_torch.spectral import laplacian as lap
    from pose6d_tpu_torch.spectral import operators as ops
    pts = np.asarray(xyz, np.float64)
    _, frames, _ = lap.pca_normals_and_frames(pts, k=30)
    _, idx = cKDTree(pts).query(pts, k=min(30, len(pts)))
    gX, gY = ops._build_gradients(pts, frames, list(idx))
    gi, gx, gy = ops.gradients_to_gather(gX, gY)
    return {"grad_idx": gi, "grad_cx": gx, "grad_cy": gy}


def variant_items(items, frames) -> list:
    """One training item per LM frame with the gradient operators of its
    CAD and PC added (for the gradient-feature variants)."""
    out = []
    for f in frames:
        cad_ops, pc_ops, obj = next(it for it in items
                                    if it[2]["obj_id"] == f["obj"])
        out.append(({**cad_ops, **gradient_ops(cad_ops["xyz"])},
                    {**pc_ops, **gradient_ops(pc_ops["xyz"])}, obj))
    return out


def variants_phase(vitems, dev, gpu_line: str) -> dict:
    """Every model variant at full width (CAD 5120, PC 2048, K 64, n_fmap
    30) on the LM pair (B = 2, both frames), weights drawn as flax draws
    them from seed 0: one forward on the card against the port's CPU
    (VARIANT_TOL), the card's forward timed. Then one train step of
    TRAIN_VARIANT (double + gradient features + ratio 0.5) at B = 2 on
    the card against the CPU: loss, grad norm and every gradient leaf
    under train_check's rule. Returns the launch counts of the card's
    forwards and step."""
    from pose6d_tpu_torch.data.pipeline import collate, make_sample, to_device
    from pose6d_tpu_torch.models import DPFMConfig, DPFMNet, init_like_flax
    from pose6d_tpu_torch.ops import sampling
    from pose6d_tpu_torch.ops.kernels import reset_launches
    from pose6d_tpu_torch.ops.kernels._build import LAUNCHES_BY_INSTANCE
    batch = collate([make_sample(*it, rng=np.random.default_rng(i))
                     for i, it in enumerate(vitems)])
    cpu_b, dev_b = to_device(batch, "cpu"), to_device(batch, dev)
    # FPS and its 3-NN on the CAD side (ratio 0.5: 2560 picks): exact
    idx_c, _ = sampling.farthest_point_sample(cpu_b["cad"]["xyz"],
                                              cpu_b["cad"]["valid"], 2560)
    idx_g, _ = sampling.farthest_point_sample(dev_b["cad"]["xyz"],
                                              dev_b["cad"]["valid"], 2560)
    fps_diff = int((idx_g.cpu() != idx_c).sum())
    reset_launches()
    for name, kw in VARIANTS.items():
        cfg = DPFMConfig(**kw)
        cpu = init_like_flax(DPFMNet(cfg), torch.Generator().manual_seed(0))
        card = cpu_copy(cpu).to(dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu.eval()(cpu_b["cad"], cpu_b["pc"])
            cpu_s = time.perf_counter() - t0
            out = card(dev_b["cad"], dev_b["pc"])       # warm
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: card(dev_b["cad"], dev_b["pc"]), 3, 0)
            out = card(dev_b["cad"], dev_b["pc"])
        errs = {}
        for key, r in ref.items():
            frac = VARIANT_TOL["C" if key == "C" else "other"]
            e = (out[key].cpu() - r).abs().max().item()
            errs[key] = e / r.abs().max().item()
            if not (e <= frac * r.abs().max().item()
                    and torch.isfinite(out[key]).all()):
                raise AssertionError(f"variant {name}: {key} apart by {e} "
                                     f"(max {r.abs().max().item()})")
        emit("variants", variant=name, config=kw, batch=2, card_ms=ms,
             cpu_s=cpu_s, rel_err=errs, fps_picks_differing=fps_diff,
             gpu=gpu_line, tol="C 1e-3 of max |C|, the rest 1e-4 of max")
    if fps_diff:
        raise AssertionError(f"FPS picks differ card vs CPU: {fps_diff}")
    launched(PATH_KERNELS["variants"][:1], "variants forwards")
    forwards = {f"{k[0]} {k[1]}x{k[2]}": v for k, v in
                LAUNCHES_BY_INSTANCE.items()}
    variant_train_step(batch, dev, gpu_line)
    counts = launched(PATH_KERNELS["variants"], "variants")
    emit("variant_launches", forwards=forwards,
         forwards_and_step={f"{k[0]} {k[1]}x{k[2]}": v for k, v in
                            LAUNCHES_BY_INSTANCE.items()}, total=counts,
         note="per kernel and (head dim x heads): the 9 variants' "
              "forwards (B = 2), then the train step's forward and "
              "backward")
    return counts


def variant_train_step(batch, dev, gpu_line: str) -> None:
    """One TrainStep of TRAIN_VARIANT on the card and on the CPU from the
    same flax-like init and draws (augmentation on); held as train_check
    holds the default model's step, but for the gradient norm's bound
    (VARIANT_NORM_TOL)."""
    from pose6d_tpu_torch.data.pipeline import to_device
    from pose6d_tpu_torch.models import DPFMConfig, DPFMNet, init_like_flax
    from pose6d_tpu_torch.train.train_step import TrainStep
    import pose6d_tpu_torch.models.attention as attention
    from pose6d_tpu_torch.ops.kernels import flash_cross_attention_plain
    cfg = DPFMConfig(**TRAIN_VARIANT)
    init = init_like_flax(DPFMNet(cfg), torch.Generator().manual_seed(1))
    res = {}
    kernel = attention.flash_cross_attention
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev),
                    ("cuda_plain", dev)):
        # the third side: the card with the plain attention, which tells
        # the kernels' share of the card / CPU gap from the rest's
        attention.flash_cross_attention = (flash_cross_attention_plain
                                           if name == "cuda_plain" else
                                           kernel)
        model = cpu_copy(init).to(d).train()
        ts = TrainStep(model, lr=5e-4, augment_angle=math.radians(15.0),
                       augment_trans=1.0)
        draws = ts.draw(to_device(batch, "cpu"),
                        torch.Generator().manual_seed(0))
        draws = {k: v.to(d) for k, v in draws.items()}
        b = to_device(batch, d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = ts.forward_loss(b, draws)
        grads = ts.backward(loss)
        if d.type == "cuda":
            torch.cuda.synchronize()
        names = [n for n, _ in model.named_parameters()]
        res[name] = dict(loss=loss.item(), s=time.perf_counter() - t0,
                         grads={n: g.detach().to("cpu", copy=True)
                                for n, g in zip(names, grads)},
                         norm=float(torch.sqrt(sum((g.double() ** 2).sum()
                                                   for g in grads))))
    attention.flash_cross_attention = kernel
    cpu, gpu, plain = res["cpu"], res["cuda"], res["cuda_plain"]
    gmax = max(v.abs().max().item() for v in cpu["grads"].values())
    ratios, dead = [], []
    for n, gc in cpu["grads"].items():
        gg = gpu["grads"][n]
        tol = 1e-2 * gc.abs().max().item() + 1e-4 * gmax
        ratios.append(((gg - gc).abs().max().item() / tol, n,
                       gc.norm().item(), (gg - gc).norm().item()))
        if gc.any() and not gg.any():
            dead.append(n)
    ratios.sort(reverse=True)
    # (error / tolerance, leaf, |g| on the CPU, |g_card - g_cpu|), and the
    # leaves that carry most of the norm
    emit("variants", variant="train_step", config=TRAIN_VARIANT, batch=2,
         loss=[cpu["loss"], gpu["loss"]], grad_norm=[cpu["norm"],
                                                    gpu["norm"]],
         norm_rel_diff=abs(gpu["norm"] - cpu["norm"]) / cpu["norm"],
         plain_attention_loss=plain["loss"],
         plain_attention_norm=plain["norm"],
         plain_attention_norm_rel_diff=abs(plain["norm"] - cpu["norm"])
         / cpu["norm"], leaves=len(ratios), worst_grad_err_over_tol=ratios[0][0],
         worst_leaves=ratios[:3],
         largest_leaves=sorted(ratios, key=lambda r: -r[2])[:3],
         cpu_s=cpu["s"], cuda_s=gpu["s"], gpu=gpu_line,
         tol="loss 1e-4 rel, grad norm 2e-3 rel (VARIANT_NORM_TOL), each "
             "gradient leaf 1e-2 of its max + 1e-4 of the largest",
         note="the gather's backward adds with atomics on the card: these "
              "gradients vary from run to run in the last bits")
    if not abs(gpu["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"]):
        raise AssertionError(f"variant step loss {gpu['loss']} vs "
                             f"{cpu['loss']}")
    if not abs(gpu["norm"] - cpu["norm"]) <= VARIANT_NORM_TOL * cpu["norm"]:
        raise AssertionError(f"variant grad norm {gpu['norm']} vs "
                             f"{cpu['norm']}")
    if dead or not ratios[0][0] <= 1.0:
        raise AssertionError(f"variant step gradients: dead {dead}, worst "
                             f"{ratios[:3]}")


# config/unseen_lm300_hks_aug180.yaml's model block (the round-4 unseen
# winner's configuration; the GPU host has no PyYAML, and a CPU test
# holds this copy to the file)
WINNER_MODEL = {
    "fmap": {"n_fmap": 30, "k_eig": 64, "n_feat": 32, "C_in": 3,
             "lambda_": 100, "resolvant_gamma": 0.5, "robust": True,
             "input_features": "xyz_hks", "n_hks": 16},
    "attention": {"num_head": 2, "gnn_dim": 32, "ref_n_layers": 1,
                  "cross_sampling_ratio": 1.0, "attention_type": "normal"},
    "overlap": {"overlap_feat_dim": 32}}
WINNER_WEIGHTS = ROOT / "weights" / "synth_unseen300_hks_aug.msgpack"


def base_survivors(model, cad, pc, diam) -> tuple:
    """(spatial-filter survivors of the base map, valid PC points) of one
    padded pair on its device: the weak-base gate's inputs."""
    from pose6d_tpu_torch.solvers import spatial_filtering_fmap2pointmap
    k = model.cfg.n_fmap
    with torch.inference_mode():
        C = model(cad, pc)["C"]
        _, pvalid = spatial_filtering_fmap2pointmap(
            C, cad["evecs"][..., :k], pc["evecs"][..., :k], cad["xyz"],
            pc["xyz"], cad["valid"], pc["valid"],
            torch.as_tensor([diam], dtype=torch.float32, device=C.device))
    return int(pvalid.sum()), int(pc["valid"].sum())


# a variant_serve request is determined, and its pose held card against
# CPU, when its base map is strong by the system's own weak-base gate
# (solvers/candidates.select_candidate): spatial-filter survivors >= 0.25
# x the valid PC points, on the CPU's run. Fixed before the first run.
SERVE_TRIGGER = 0.25


def variant_serve(online, frames, gpu_line: str) -> dict:
    """The round-4 unseen winner (xyz_hks, WINNER_WEIGHTS) served on the
    card: Predictor.predict on the two rendered frames (online, flip
    disambiguation on) and predict_with_operators on the two LM frames
    (cached), round 1 timed (host clock around a synchronised call).
    Then the same requests through the port on the CPU, with the same
    draws (and LOBPCG start): the online cloud stage under
    online_cpu_agreement's rule (points exact, keep masks equal, FPS
    picks or covering radii within 1 %, the first 30 eigenvalues within
    1e-3 relative), and every determined request's pose (SERVE_TRIGGER)
    within 1 deg and 1 % of the diameter. At least one request must be
    determined. Returns the launch counts of the card's requests."""
    from pose6d_tpu_torch.api import Predictor, pad_operators
    from pose6d_tpu_torch.data.synth import default_intrinsics
    from pose6d_tpu_torch.models import DPFMConfig, DPFMNet, load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import reset_launches
    cfg = DPFMConfig.from_yaml_dict(WINNER_MODEL)
    model = load_flax_checkpoint(WINNER_WEIGHTS, DPFMNet(cfg)).cuda().eval()
    K = default_intrinsics()
    rng = np.random.default_rng(2)
    draws = {f["obj"]: rng.random((ONLINE_DRAW_BLOCKS, 512, 3),
                                  dtype=np.float32) for f in online + frames}
    on_pred = Predictor(model, {f["obj"]: f["cad_ops"] for f in online},
                        mode="online", device="cuda")
    ca_pred = Predictor(model, {f["obj"]: f["cad_ops"] for f in frames},
                        mode="cached", device="cuda")
    requests = [(f, "online") for f in online] + [(f, "cached")
                                                  for f in frames]
    reset_launches()
    card, ms = {}, {}
    for rnd in range(2):                  # round 0 includes first-call set-up
        for f, mode in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "online":
                out = on_pred.predict(f["depth"], K, 1.0, [f["mask"]],
                                      [f["obj"]],
                                      uniforms=[draws[f["obj"]]])[0]
            else:
                out = ca_pred.predict_with_operators(
                    f["obj"], f["pc_ops"], uniforms=draws[f["obj"]])
            ms[f["obj"]] = 1e3 * (time.perf_counter() - t0)
            card[f["obj"]] = out
    counts = launched(PATH_KERNELS["variant_serve"], "variant_serve")
    gpu_stages = {f["obj"]: online_stages(on_pred, f, draws[f["obj"]],
                                          timed=False) for f in online}

    cpu_model = cpu_copy(model)
    cpu_on = Predictor(cpu_model, {f["obj"]: f["cad_ops"] for f in online},
                       mode="online", device="cpu")
    cpu_ca = Predictor(cpu_model, {f["obj"]: f["cad_ops"] for f in frames},
                       mode="cached", device="cpu")
    held = 0
    for f, mode in requests:
        obj, out = f["obj"], card[f["obj"]]
        t0 = time.perf_counter()
        extra = {}
        if mode == "online":
            st = online_stages(cpu_on, f, draws[obj], timed=False)
            ref = {"R": st["R"], "t": st["t"],
                   "flip_hypothesis": st["hypothesis"]}
            extra, cloud_ok = cloud_stage_agreement(gpu_stages[obj], st)
            extra["flip_hypothesis"] = [int(out["flip_hypothesis"]),
                                        int(ref["flip_hypothesis"])]
            if not cloud_ok:
                raise AssertionError(f"variant_serve: the online cloud "
                                     f"stage of obj {obj} differs: {extra}")
            cad = {k: v[None] for k, v in cpu_on.cad_bank[obj].items()}
            surv = base_survivors(cpu_model, cad, st["ops"],
                                  cpu_on._diam[obj])
        else:
            ref = cpu_ca.predict_with_operators(obj, f["pc_ops"],
                                                uniforms=draws[obj])
            cad = {k: v[None] for k, v in cpu_ca.cad_bank[obj].items()}
            pc = {k: v[None] for k, v in pad_operators(
                f["pc_ops"], cpu_ca.v_pc, "cpu").items()}
            surv = base_survivors(cpu_model, cad, pc, cpu_ca._diam[obj])
        cpu_s = time.perf_counter() - t0
        determined = surv[0] >= SERVE_TRIGGER * surv[1]
        dr = rot_deg(out["R"], ref["R"])
        dt = float(np.linalg.norm(out["t"] - ref["t"]) / f["diam"])
        emit("variant_serve", obj=obj, mode=mode, ms=ms[obj],
             gpu=gpu_line, n_inliers=int(out["n_inliers"]),
             base_survivors=surv[0], valid_pc_points=surv[1],
             determined=bool(determined), rot_deg=dr, t_frac_diam=dt,
             rot_err_deg=rot_deg(out["R"], f["R_gt"]),
             t_err_frac_diam=float(np.linalg.norm(out["t"] - f["t_gt"])
                                   / f["diam"]),
             cpu_s=cpu_s, **extra,
             tol="pose 1 deg and 1 % diam where determined (base survivors "
                 ">= 0.25 x valid PC points on the CPU)")
        if determined:
            held += 1
            if not (dr <= 1.0 and dt <= 0.01):
                raise AssertionError(f"variant_serve: card and CPU poses "
                                     f"of obj {obj} apart: {dr} deg, {dt}")
    if not held:
        raise AssertionError("variant_serve: no request is determined")
    return counts


def training_items(frames) -> list:
    """The in-memory training set: each committed frame with its GT
    pairs at 0.05 diam from its GT pose, four copies of each, so one
    batch of 8 holds four of both."""
    from pose6d_tpu_torch.data.dataset import gt_object
    items = []
    for f in frames:
        obj = gt_object(f["cad_ops"]["xyz"], f["pc_ops"]["xyz"], f["R_gt"],
                        f["t_gt"], f["diam"], f["obj"])
        items += [(f["cad_ops"], f["pc_ops"], obj)] * 4
    return items


def train_check(items, dev) -> None:
    """One train step on the card against the same step on the port's
    CPU run: params from weights/synth_seen.msgpack, one frame of each
    object, the same draws (augmentation on)."""
    from pose6d_tpu_torch.data.pipeline import collate, make_sample, to_device
    from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from pose6d_tpu_torch.train.train_step import TrainStep
    batch = collate([make_sample(*items[i], rng=np.random.default_rng(i))
                     for i in (0, 4)])
    lr = 5e-4
    res = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = load_flax_checkpoint(ROOT / "weights" / "synth_seen.msgpack",
                                     DPFMNet()).to(d)
        ts = TrainStep(model, lr=lr, augment_angle=math.radians(15.0),
                       augment_trans=1.0)
        b = to_device(batch, d)
        draws = ts.draw(to_device(batch, "cpu"),
                        torch.Generator().manual_seed(0))
        draws = {k: v.to(d) for k, v in draws.items()}
        reset_launches()
        t0 = time.perf_counter()
        loss, _, _ = ts.forward_loss(b, draws)
        names = [n for n, _ in model.named_parameters()]
        grads = ts.backward(loss)
        # a copy: the clip scales the gradients in place (and .cpu() of
        # a CPU tensor is the tensor itself)
        g = {n: t.detach().to("cpu", copy=True) for n, t in zip(names, grads)}
        norm = ts.apply_update(grads, 0)
        if d.type == "cuda":
            torch.cuda.synchronize()
        res[name] = dict(loss=loss.item(), norm=norm.item(), grads=g,
                         params={n: p.detach().to("cpu", copy=True)
                                 for n, p in model.named_parameters()},
                         s=time.perf_counter() - t0, launches=dict(LAUNCHES))
    cpu, gpu = res["cpu"], res["cuda"]
    # f32 on both; the regularized 30x30 fmap solve amplifies summation
    # order (as in tests/test_torch_train.py against the JAX step)
    if not abs(gpu["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"]):
        raise AssertionError(f"train loss {gpu['loss']} vs {cpu['loss']}")
    if not abs(gpu["norm"] - cpu["norm"]) <= 1e-3 * cpu["norm"]:
        raise AssertionError(f"grad norm {gpu['norm']} vs {cpu['norm']}")
    # Gradient leaves: 1e-2 of the leaf's max plus 1e-4 of the step's
    # largest gradient. At full width each gradient sums over 5120 CAD
    # and 2048 PC points (and 2 x 5120 x 2048 attention pairs) in another
    # order; with the plain attention on the card the worst leaf sits at
    # ~4e-3 of its max. The floor is for leaves that are 0 in exact
    # arithmetic: proj_k's bias (a softmax does not see a shift of all
    # its keys) comes out as ~5e-5 of the largest gradient through the
    # backward kernel, which takes D_i = dout_i . out_i from the
    # forward's output rather than from its own probabilities
    gmax = max(v.abs().max().item() for v in cpu["grads"].values())
    ratios, dead = [], []
    for name, gc in cpu["grads"].items():
        gg = gpu["grads"][name]
        tol = 1e-2 * gc.abs().max().item() + 1e-4 * gmax
        err = (gg - gc).abs().max().item()
        ratios.append((err / tol, name, err, gc.abs().max().item(),
                       gg.abs().max().item()))
        if gc.any() and not gg.any():
            dead.append(name)
        # one RMSprop step moves each parameter by ~10 lr sign(g): equal
        # where |g| is ten times the gradient tolerance, at most 20 lr
        # apart elsewhere (a sign flip of a gradient that is noise, as
        # proj_k's bias gradient is: 0 in exact arithmetic)
        clear = gc.abs() > 10 * tol
        dp = (gpu["params"][name] - cpu["params"][name]).abs()
        if not (dp[clear].max().item() <= 1e-5 if clear.any() else True) \
                or not dp.max().item() <= 20 * lr:
            raise AssertionError(f"{name}: params apart by {dp.max()}")
    if dead:
        raise AssertionError(f"no gradient on the card for {dead}")
    # (error / tolerance, leaf, error, max |g| on the CPU, on the card)
    ratios.sort(reverse=True)
    worst = ratios[0][0]
    if not worst <= 1.0:
        raise AssertionError(f"gradients apart by {worst} x the tolerance: "
                             f"{ratios[:3]}")
    launched(("flash_cross_attention", "flash_cross_attention_backward"),
             "train_check")
    emit("train_check", loss=[cpu["loss"], gpu["loss"]],
         grad_norm=[cpu["norm"], gpu["norm"]], leaves=len(cpu["grads"]),
         worst_grad_err_over_tol=worst, worst_leaves=ratios[:3],
         tol="loss 1e-4 rel, grad norm 1e-3 rel, each gradient leaf "
             "1e-2 of its max + 1e-4 of the largest; params 1e-5 where "
             "|g| > 10x that, else 20 lr",
         attention_grad_norms={n: float(v.norm()) for n, v in
                               gpu["grads"].items() if ".attn." in n},
         cpu_s=cpu["s"], cuda_s=gpu["s"], cuda_launches=gpu["launches"])


def train_run(items, dev, gpu_line: str) -> dict:
    """The port's train() on the card at full width from a flax-like
    init, then the step's time split into its stages and a profiled
    step. Returns the launch counts of the train() run."""
    import shutil

    from pose6d_tpu_torch.config import Config
    from pose6d_tpu_torch.data.pipeline import collate, make_sample, to_device
    from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import reset_launches
    from pose6d_tpu_torch.train.loop import train
    from pose6d_tpu_torch.train.train_step import TrainStep
    steps = 20
    cfg = Config()
    cfg.logging_dir = str(ROOT / "build" / "chip_smoke_train")
    shutil.rmtree(cfg.logging_dir, ignore_errors=True)
    cfg.train.batch_size = TRAIN_BATCH
    cfg.train.epochs = steps
    cfg.train.log_ir = True
    cfg.train.log_interval = 5
    cfg.train.checkpoint_interval = 10
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(cfg, dataset=items, max_steps=steps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launched(PATH_KERNELS["train"], "train")
    (run,) = Path(cfg.logging_dir).iterdir()
    recs = [json.loads(ln) for ln in
            (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "step" in r]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    back = load_flax_checkpoint(run / "params_latest.msgpack", DPFMNet())
    for name, t in state.model.state_dict().items():
        if not torch.equal(back.state_dict()[name], t.cpu()):
            raise AssertionError(f"params_latest.msgpack differs at {name}")
    emit("train", steps=steps, batch=TRAIN_BATCH, losses=losses,
         mean_first5=first, mean_last5=last,
         IR=[r["IR"] for r in recs if "IR" in r], wall_s=wall,
         wall_ms_per_step=1e3 * wall / steps,
         note="wall includes the host loader, checkpoints and the IR "
              "probe; set-up included", launches=counts)

    # the step alone on one batch of 8: CUDA events around each stage
    model = state.model
    ts = TrainStep(model, cfg.loss, lr=cfg.train.lr)
    batch = to_device(collate([make_sample(*items[i]) for i in range(
        TRAIN_BATCH)]), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    names = ("forward", "backward", "optimizer")
    reps = 10
    for _ in range(2):
        ts(batch, 0, ts.draw(batch, gen))
    torch.cuda.synchronize()
    stage = dict.fromkeys(names, 0.0)
    total = 0.0
    for _ in range(reps):
        draws = ts.draw(batch, gen)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _, _ = ts.forward_loss(batch, draws)
        ev[1].record()
        grads = ts.backward(loss)
        ev[2].record()
        ts.apply_update(grads, 0)
        ev[3].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            stage[n] += ev[i].elapsed_time(ev[i + 1]) / reps
        total += ev[0].elapsed_time(ev[3]) / reps
    emit("train_step", batch=TRAIN_BATCH, ms_per_step=total,
         samples_per_s=TRAIN_BATCH * 1e3 / total, stage_ms=stage,
         gpu=gpu_line, **profile_steps(ts, batch, gen))
    return counts


def profile_steps(ts, batch, gen, n: int = 3) -> dict:
    """Device time of n train steps (torch.profiler) over their wall
    time without the profiler, and the kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ts(batch, 0, ts.draw(batch, gen))
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0)

    wall_us = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    if device_us == 0:
        return {"device_busy_share": "not measured (no device time traced)"}
    return {"wall_ms_per_step_unprofiled": wall_us / n / 1e3,
            "device_ms_per_step": device_us / n / 1e3,
            "device_busy_share": device_us / wall_us,
            "top_device_ms_per_step": {
                e.key[:60]: e.self_device_time_total / n / 1e3
                for e in rows[:8]},
            "device_launches_per_step": sum(e.count for e in rows) / n}


# evaluate()'s result npz, as the JAX package writes it
# (pose6d_tpu/train/eval_loop.py:296-325)
NPZ_KEYS = ("C_pred", "K", "R_m2c", "align_pc", "cad_xyz", "diam_cad",
            "evecs_cad", "evecs_pc", "im_hw", "ir", "obj_id", "overlap12",
            "overlap21", "p_pred", "pcd_depth", "t_m2c")
EVAL_DIR = ROOT / "build" / "chip_smoke_eval"


def ops_digest(ops: dict) -> str:
    """The first 16 hex digits of a SHA-256 over the operators' bytes:
    whether two runs computed the same operators."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(ops):
        h.update(np.ascontiguousarray(ops[k]).tobytes())
    return h.hexdigest()[:16]


def eval_dataset(frames, online, stages) -> list:
    """Four (cad_ops, pc_ops, obj) instances: the two LM frames (no
    intrinsics) and the two rendered online frames under object ids 1
    and 2, with their card-computed operators, the LM intrinsics and
    the 480 x 640 image size; GT pairs from data.dataset.gt_object."""
    from pose6d_tpu_torch.data.dataset import gt_object
    from pose6d_tpu_torch.data.synth import default_intrinsics
    items = []
    for f in frames:
        obj = gt_object(f["cad_ops"]["xyz"], f["pc_ops"]["xyz"], f["R_gt"],
                        f["t_gt"], f["diam"], f["obj"])
        items.append((f["cad_ops"], f["pc_ops"], obj))
    for obj_id, f in enumerate(online, start=1):
        ops = stages[f["obj"]]["ops"]
        v = ops["valid"][0].cpu().numpy()
        pc_ops = {k: ops[k][0].cpu().numpy()[v] for k in ("xyz", "mass",
                                                          "evecs")}
        pc_ops["evals"] = ops["evals"][0].cpu().numpy()
        obj = gt_object(f["cad_ops"]["xyz"], pc_ops["xyz"], f["R_gt"],
                        f["t_gt"], f["diam"], obj_id, K=default_intrinsics(),
                        im_hw=(480, 640))
        items.append((f["cad_ops"], pc_ops, obj))
    emit("eval_dataset", objects=[it[2]["obj_id"] for it in items],
         pc_ops_sha256=[ops_digest(it[1]) for it in items],
         cad_points=[len(it[0]["xyz"]) for it in items],
         pc_points=[len(it[1]["xyz"]) for it in items],
         gt_pairs=[len(it[2]["P"]) for it in items],
         intrinsics=["K" in it[2] for it in items])
    return items


def eval_config(candidates: bool):
    from pose6d_tpu_torch.config import Config
    cfg = Config()
    if candidates:
        cfg.eval.batch_size = 2
        cfg.eval.tta_rotations = 4
        cfg.eval.zoomout_k = 64
        cfg.eval.zoomout_gate_tau = 0.15
        cfg.eval.select_by = "depth"
    else:
        cfg.eval.batch_size = 4
    return cfg


def eval_results(d, i: int) -> dict:
    return dict(np.load(Path(d) / f"result_{i:06d}.npz"))


def bits_differ(a: dict, b: dict) -> list:
    """The keys whose arrays differ in dtype, shape or any bit."""
    return [k for k in a if a[k].dtype != b[k].dtype
            or a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes()]


def eval_phase(items, model, gpu_line: str):
    """evaluate() on the card (the path: each configuration once, its
    launches counted): the reference's settings, batch 4; TTA 4 +
    ZoomOut 64 gated at 0.15, depth selection, batch 2 (the LM batch
    lacks intrinsics and falls back to survivor counts, the rendered
    batch takes the depth score). Then each configuration once more on
    the card in the same process, its npz files compared bit for bit
    (whether the card path is deterministic), and on the port's CPU
    with the same operators and draws.

    Held against the CPU, with no exemption: every npz's keys, dtypes
    and shapes (the JAX layout); per-instance IR within 0.01 and the same
    winner on every instance of the reference run, and on every instance
    of the candidate run whose base map is strong (its spatial-filter
    survivors, the reference run's CPU p_pred, at least select_trigger of
    its points): the weak-base trigger then keeps the base map, so the
    winner and IR are the base map's. Where the trigger engages, every
    candidate competes on a weak map's correspondences, whose filters,
    ZoomOut refits and cheap RANSAC poses rounding can move: those
    instances are printed (engaged) and not held, and the CPU runs the
    candidate configuration only on the batches that hold an instance
    it decides. The candidate mechanisms are held on determined inputs
    in zoomout_check and predictor_candidates. Returns the candidate
    run's npz directory and the path's launch counts."""
    import shutil

    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from pose6d_tpu_torch.train.eval_loop import evaluate, select_uniforms
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    runs = (("reference", False), ("tta4_zoomout64", True))
    sel, card_s, counts = {}, {}, {}
    reset_launches()
    before = dict(LAUNCHES)
    for label, cand in runs:
        sel[label] = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(eval_config(cand), model, items,
                 save_dir=EVAL_DIR / label / "cuda", device="cuda",
                 selection=sel[label])
        torch.cuda.synchronize()
        card_s[label] = time.perf_counter() - t0
        counts[label] = {k: (LAUNCHES[k] - before[k]) / len(items)
                         for k in LAUNCHES}
        before = dict(LAUNCHES)
    paths = launched(PATH_KERNELS["eval"], "eval")

    cpu_model = cpu_copy(model)
    for label, cand in runs:
        cfg = eval_config(cand)
        bs = cfg.eval.batch_size
        d = EVAL_DIR / label
        again = []
        evaluate(cfg, model, items, save_dir=d / "cuda_again",
                 device="cuda", selection=again)
        held = []
        for i in range(len(items)):
            ref = eval_results(EVAL_DIR / "reference" / "cpu", i) \
                if cand else None
            held.append(not cand or len(ref["p_pred"]) >= (
                cfg.eval.select_trigger * len(ref["pcd_depth"])))
        cpu_sel, cpu_s = {}, 0.0
        for lo in range(0, len(items), bs):
            if not any(held[lo:lo + bs]):
                continue
            got = []
            t0 = time.perf_counter()
            evaluate(cfg, cpu_model, items[lo:lo + bs],
                     save_dir=d / "cpu" / f"from_{lo}", device="cpu",
                     selection=got,
                     select_draws=lambda idx, n, h, lo=lo: select_uniforms(
                         idx + lo, n, h))
            cpu_s += time.perf_counter() - t0
            cpu_sel.update({lo + j: x for j, x in enumerate(got)})
            for j in range(len(got)):
                shutil.copy(d / "cpu" / f"from_{lo}" / f"result_{j:06d}.npz",
                            d / "cpu" / f"result_{lo + j:06d}.npz")
        rows, repeat_differs, failed = [], {}, []
        for i in range(len(items)):
            a = eval_results(d / "cuda", i)
            b = eval_results(d / "cpu" if i in cpu_sel
                             else EVAL_DIR / "reference" / "cuda", i)
            if tuple(sorted(a)) != NPZ_KEYS or sorted(b) != sorted(a):
                raise AssertionError(f"eval {label} {i}: keys {sorted(a)}")
            bad = [k for k in a if a[k].dtype != b[k].dtype
                   or a[k].shape[1:] != b[k].shape[1:]
                   or (k != "p_pred" and a[k].shape != b[k].shape)]
            if bad:
                raise AssertionError(f"eval {label} {i}: layout {bad}")
            differ = bits_differ(a, eval_results(d / "cuda_again", i))
            if differ or again[i] != sel[label][i]:
                repeat_differs[i] = differ + (
                    ["winner or scores"] if again[i] != sel[label][i] else [])
            row = {"instance": i, "held": held[i],
                   "winner_cuda": sel[label][i]["winner"],
                   "ir_cuda": float(a["ir"]),
                   "scores_cuda": sel[label][i]["scores"]}
            if i in cpu_sel:
                ir = [float(a["ir"]), float(b["ir"])]
                win = [sel[label][i]["winner"], cpu_sel[i]["winner"]]
                row.update(ir_cpu=ir[1], winner_cpu=win[1],
                           scores_cpu=cpu_sel[i]["scores"],
                           agree=abs(ir[0] - ir[1]) <= 0.01
                           and win[0] == win[1],
                           p_pred_equal=bool(np.array_equal(a["p_pred"],
                                                            b["p_pred"])))
                if held[i] and not row["agree"]:
                    failed.append(i)
            rows.append(row)
        emit("eval", run=label, gpu=gpu_line, batch=bs,
             ms_per_instance=1e3 * card_s[label] / len(items),
             cpu_s_per_instance=cpu_s / max(len(cpu_sel), 1),
             launches_per_instance=counts[label], card_vs_cpu=rows,
             card_repeat_bit_equal=not repeat_differs,
             card_repeat_differs=repeat_differs,
             tol="IR 0.01 and the same winner on every held instance (its "
                 "base map strong, or no candidates); the others printed",
             timing="host clock around evaluate() (host loader, npz "
                    "writing included), device synchronised at the end")
        if failed:
            raise AssertionError(f"eval {label}: card and CPU disagree on "
                                 f"{failed}")
    return EVAL_DIR / "tta4_zoomout64" / "cuda", paths


def gt_results(results_dir, out_dir, radius: float) -> list:
    """Copies of the npz files whose p_pred is GT-derived: each observed
    point paired with its nearest CAD point under the GT pose
    (align_pc), kept where that distance is below `radius`. Returns the
    pair counts."""
    from scipy.spatial import cKDTree
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = []
    for f in sorted(Path(results_dir).glob("result_*.npz")):
        r = dict(np.load(f))
        dist, j = cKDTree(r["cad_xyz"].astype(np.float64)).query(
            r["align_pc"].astype(np.float64))
        keep = np.nonzero(dist < radius)[0]
        r["p_pred"] = np.stack([j[keep], keep], 1).astype(r["p_pred"].dtype)
        np.savez(out_dir / f.name, **r)
        counts.append(len(keep))
    return counts


F32_EPS = 2.0 ** -23


def pose_agreement(a, b, j: int, diam: float, reach: float) -> dict:
    """Chunk row j of two runs: T_icp's rotation (deg) and translation
    (fraction of the diameter) apart, the flip hypotheses, and the
    largest excess of the ADD and ADD-S distances (before and after ICP)
    over 1e-3 relative plus each metric's f32 resolution at `reach`, the
    farthest posed CAD point from the camera: ADD differences points
    directly (a few ulps of a coordinate, 8 eps reach), ADD-S reads its
    nearest-neighbour distances from |a|^2 - 2 a.b + |b|^2, exact to
    ~eps reach^2, so a distance near zero to ~sqrt(eps) reach (0.035 cm
    at 1 m). A pose on the GT-posed CAD leaves both at that rounding."""
    out = {"rot_deg": rot_deg(a["T_icp"][j][:3, :3], b["T_icp"][j][:3, :3]),
           "t_frac_diam": float(np.linalg.norm(
               a["T_icp"][j][:3, 3] - b["T_icp"][j][:3, 3]) / diam),
           "flip": [int(a["flip_hyp"][j]), int(b["flip_hyp"][j])]}
    for name, atol, pairs in (
            ("add", 8 * F32_EPS * reach, ((a["pre"][0], b["pre"][0]),
                                          (a["post"][0], b["post"][0]))),
            ("adds", math.sqrt(F32_EPS) * reach,
             ((a["adds_pre"], b["adds_pre"]),
              (a["adds_post"], b["adds_post"])))):
        vals = [(float(x[j]), float(y[j])) for x, y in pairs]
        out[name] = vals
        out[f"{name}_atol_cm"] = atol
        out[f"{name}_excess"] = max(abs(x - y) - (1e-3 * abs(y) + atol)
                                    for x, y in vals)
    return out


def pose_ok(g: dict) -> bool:
    return (g["rot_deg"] <= 1.0 and g["t_frac_diam"] <= 0.01
            and g["add_excess"] <= 0.0 and g["adds_excess"] <= 0.0
            and g["flip"][0] == g["flip"][1])


POSE_RUNS = (("ransac", {"disambiguate": True, "icp_target": "gt_cad"}),
             ("gnc", {"icp_target": "pc"}))


def run_pose(results_dir, out_dir, solver, dev, **kw) -> dict:
    """One run_pose_stage call: its chunks, host ms, stage split (card)
    and the host syncs it caused (card, set_sync_debug_mode warnings)."""
    import warnings

    from pose6d_tpu_torch.train.pose_stage import run_pose_stage
    chunks, ms = [], {} if dev == "cuda" else None
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode(1)
        try:
            run_pose_stage(results_dir, out_dir, solver=solver, device=dev,
                           stage_ms=ms, chunks=chunks, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"chunks": chunks, "ms": 1e3 * (time.perf_counter() - t0),
            "split": ms, "n": sum(len(c["i"]) for c in chunks),
            "syncs": sum("synchroniz" in str(w.message) for w in caught)}


def pose_stage_runs(results_dir, gpu_line: str):
    """run_pose_stage on the card over the candidate run's npz files at
    full budgets (131072 hypotheses, 50 ICP iterations): RANSAC with
    depth-render disambiguation and ICP against the GT-posed CAD; GNC
    with ICP against the observed cloud (the path: each once, its
    launches counted). Each runs once more on the card, its outputs
    compared bit for bit (whether the card path is deterministic).

    Held against the port's CPU, with no exemption, on inputs whose
    answer is determined: the same files with GT-derived correspondences
    (gt_results, pairs within the 0.05 cm RANSAC threshold, at full
    width and full budgets): T_icp within 1 deg and 1 % of the diameter,
    the same flip hypothesis, ADD and ADD-S before and after ICP within
    1e-3 relative above their f32 resolution (pose_agreement). The candidate run's own
    correspondences are mostly wrong on three of its four instances
    (IR 0): RANSAC's 0.05 cm consensus on them, and ICP from the pose it
    gives, move with rounding, so that comparison decides nothing and
    the CPU does not run it. Returns the path's launch counts and the
    RANSAC run's avg_results.txt."""
    from pose6d_tpu_torch.ops.kernels import reset_launches
    gt_dir = EVAL_DIR / "gt_pairs"
    n_pairs = gt_results(results_dir, gt_dir, 0.05)
    reset_launches()
    card = {s: run_pose(results_dir, EVAL_DIR / "pose_cuda", s, "cuda", **kw)
            for s, kw in POSE_RUNS}
    paths = launched(PATH_KERNELS["pose_stage"], "pose_stage")
    keys = ("T_est", "T_icp", "flip_hyp", "adds_pre", "adds_post")
    for solver, kw in POSE_RUNS:
        g = card[solver]
        again = run_pose(results_dir, EVAL_DIR / "pose_cuda_again", solver,
                         "cuda", **kw)
        differ = sorted({k for a, b in zip(g["chunks"], again["chunks"])
                         for k in keys if not np.array_equal(a[k], b[k])}
                        | {f"{k}[{m}]" for a, b in zip(g["chunks"],
                                                       again["chunks"])
                           for k in ("pre", "post")
                           for m in range(len(a[k]))
                           if not np.array_equal(a[k][m], b[k][m])})
        sides = {d: run_pose(gt_dir, EVAL_DIR / f"pose_gt_{d}", solver, d,
                             write_ply=False, **kw) for d in ("cuda", "cpu")}
        rows, failed = [], []
        for a, b in zip(sides["cuda"]["chunks"], sides["cpu"]["chunks"]):
            for j, i in enumerate(a["i"]):
                r = eval_results(gt_dir, i)
                reach = float(np.linalg.norm(
                    r["cad_xyz"] @ r["R_m2c"].T + r["t_m2c"], axis=1).max())
                row = {"instance": i, "gt_pairs": n_pairs[i],
                       **pose_agreement(a, b, j, float(r["diam_cad"]),
                                        reach)}
                rows.append(row)
                if not pose_ok(row):
                    failed.append(i)
        emit("pose_stage", solver=solver, gpu=gpu_line, instances=g["n"],
             chunks=len(g["chunks"]), ms_per_instance=g["ms"] / g["n"],
             stage_ms=g["split"],
             host_syncs_per_chunk=g["syncs"] / len(g["chunks"]),
             syncs_counted_by="torch.cuda.set_sync_debug_mode warnings",
             card_repeat_bit_equal=not differ, card_repeat_differs=differ,
             gt_pairs_ms_per_instance={
                 d: v["ms"] / max(v["n"], 1) for d, v in sides.items()},
             gt_pairs_card_vs_cpu=rows,
             tol="on GT-derived pairs: 1 deg, 1 % diam, same flip, ADD and "
                 "ADD-S (pre and post ICP) within 1e-3 relative + their f32 "
                 "resolution (pose_agreement)")
        if failed:
            raise AssertionError(f"pose_stage {solver}: card and CPU "
                                 f"disagree on {failed} (GT-derived pairs)")
    avg = (EVAL_DIR / "pose_cuda" / "results_poses_RANSAC"
           / "avg_results.txt").read_text()
    return paths, avg


def zoomout_check(frames, dev, gpu_line: str) -> None:
    """zoomout_refine at full width on a well-conditioned pair: B = 2
    (the LM CADs padded to 5120, k 30 -> 64 in 9 rounds, gated at 0.15
    of the diameter), 2048 observed rows, each a CAD row (its xyz moved
    rigidly, its eigenvector row with 1e-4 noise), C0 the identity:
    every round's matches are determined. Card against the port's CPU:
    C within 1e-4 and the same final matches, which are the true ones."""
    from scipy.spatial.transform import Rotation

    from pose6d_tpu_torch.ops.nn import nearest_valid
    from pose6d_tpu_torch.solvers.zoomout import zoomout_refine
    from pose6d_tpu_torch.ops.masking import pad_to
    rng = np.random.default_rng(5)
    R = Rotation.from_rotvec([0.3, -0.5, 0.2]).as_matrix()
    cad, ex, cv, pc, ey, truth, diam = [], [], [], [], [], [], []
    for f in frames:
        xyz = np.asarray(f["cad_ops"]["xyz"], np.float32)
        ev = np.asarray(f["cad_ops"]["evecs"][:, :64], np.float32)
        idx = rng.choice(len(xyz), 2048, replace=False)
        cad.append(pad_to(xyz, 5120))
        ex.append(pad_to(ev, 5120))
        cv.append(np.arange(5120) < len(xyz))
        pc.append((xyz[idx] @ R.T + [2.0, -3.0, 80.0]).astype(np.float32))
        ey.append((ev[idx] + 1e-4 * rng.normal(size=(2048, 64))).astype(
            np.float32))
        truth.append(idx)
        diam.append(f["diam"])
    C0 = np.tile(np.eye(30, dtype=np.float32), (len(frames), 1, 1))
    out = {}
    for d in ("cuda", "cpu"):
        t = {k: torch.as_tensor(np.stack(v)).to(d) for k, v in (
            ("cad", cad), ("ex", ex), ("cv", cv), ("pc", pc), ("ey", ey))}
        pv = torch.ones(t["ey"].shape[:2], dtype=torch.bool, device=d)
        diam_t = torch.tensor(diam, dtype=torch.float32, device=d)
        t0 = time.perf_counter()
        C = zoomout_refine(torch.as_tensor(C0).to(d), t["ex"], t["ey"],
                           t["cv"], pv, cad_xyz=t["cad"], pc_xyz=t["pc"],
                           diam=diam_t, gate_tau=0.15)
        _, p2p = nearest_valid(t["ey"], t["ex"] @ C.transpose(-1, -2),
                               t["cv"])
        if d == "cuda":
            torch.cuda.synchronize()
        out[d] = (C.cpu().numpy(), p2p.cpu().numpy(),
                  1e3 * (time.perf_counter() - t0))
    c_err = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    same = bool(np.array_equal(out["cuda"][1], out["cpu"][1]))
    true = bool(np.array_equal(out["cuda"][1], np.stack(truth)))
    emit("zoomout_check", gpu=gpu_line, shape="B 2 x 2048 x 5120, k 30 -> 64",
         C_max_abs_diff=c_err, p2p_equal=same, p2p_true=true,
         C_offdiag_max=float(np.abs(out["cuda"][0] - np.eye(64)).max()),
         ms={"cuda": out["cuda"][2], "cpu": out["cpu"][2]},
         tol="C 1e-4, the same matches, the true matches",
         timing="host clock, first call, device synchronised at the end")
    if not (c_err <= 1e-4 and same and true):
        raise AssertionError("zoomout_refine: card and CPU disagree on a "
                             "well-conditioned pair")


def zoomout_rounds(C0, ex, ey, cad_xyz, pc_xyz, diam: float, d,
                   gate_tau: float = 0.15, step: int = 4,
                   ridge: float = 1e-6) -> list:
    """zoomout_refine's rounds (solvers/zoomout.py) on one pair on
    device d, unpadded, each round's matches, gate, normal matrix and
    map kept: [(kn, p2p, keep, M, C), ...] as numpy."""
    from pose6d_tpu_torch.ops.nn import nearest_valid
    from pose6d_tpu_torch.solvers.fmap2pointmap import _consistency_mean

    def on(x):
        return torch.as_tensor(np.asarray(x, np.float32))[None].to(d)

    ex, ey, cad_xyz, pc_xyz = on(ex), on(ey), on(cad_xyz), on(pc_xyz)
    vx = torch.ones(ex.shape[:2], dtype=torch.bool, device=d)
    vy = torch.ones(ey.shape[:2], dtype=torch.bool, device=d)
    k0, k1 = C0.shape[0], ex.shape[-1]
    C = torch.zeros((1, k1, k1), device=d)
    C[:, :k0, :k0] = on(C0)
    out = []
    for kn in list(range(k0 + step, k1, step)) + [k1]:
        _, p2p = nearest_valid(ey, ex @ C.transpose(-1, -2), vx)
        rows = torch.gather(cad_xyz, 1, p2p.long()[..., None].expand(-1, -1,
                                                                     3))
        keep = _consistency_mean(rows, pc_xyz, vy) < gate_tau * diam
        w = keep.float()[..., None]
        if float(w.sum()) < kn:
            w = torch.ones_like(w)
        A = torch.gather(ex, 1, p2p.long()[..., None].expand(
            -1, -1, k1))[..., :kn]
        M = A.transpose(-1, -2) @ (A * w) + ridge * torch.eye(kn, device=d)
        N = (A * w).transpose(-1, -2) @ ey[..., :kn]
        C = torch.zeros((1, k1, k1), device=d)
        C[:, :kn, :kn] = torch.linalg.solve(M, N).transpose(-1, -2)
        out.append((kn, p2p[0].cpu().numpy(), keep[0].cpu().numpy(),
                    M[0].double().cpu().numpy(), C[0].cpu().numpy()))
    return out


def zoomout_sensitivity(items, gpu_line: str) -> None:
    """For information, not held: where ZoomOut's refit on the
    evaluation's real maps (the LM instances, the reference run's base
    map, k 30 -> 64 gated at 0.15) parts between the card and the CPU.
    Round by round (zoomout_rounds, each device on its own state): the
    rows whose match or gate differs, the distinct CAD rows matched, the
    smallest eigenvalue of the normal matrix (ridge 1e-6 included) and
    its condition number, and each map's largest entry and difference.
    Also whether the CPU's own result moves when C0 moves by one f32
    ulp."""
    from pose6d_tpu_torch.solvers.zoomout import zoomout_refine
    out = []
    for i in (0, 1):
        cad, pc, obj = items[i]
        ref = eval_results(EVAL_DIR / "reference" / "cpu", i)
        C0 = ref["C_pred"].astype(np.float32)
        ex = np.asarray(cad["evecs"][:, :64], np.float32)
        ey = np.asarray(pc["evecs"][:, :64], np.float32)
        diam = float(obj["diam_cad"])
        tr = {d: zoomout_rounds(C0, ex, ey, cad["xyz"], pc["xyz"], diam, d)
              for d in ("cuda", "cpu")}
        rounds = []
        for (kn, pg, kg, Mg, Cg), (_, pc_, kc, Mc, Cc) in zip(tr["cuda"],
                                                             tr["cpu"]):
            ev = np.linalg.eigvalsh(Mc)
            rounds.append({"k": kn, "match_rows_differ": int((pg != pc_).sum()),
                           "gate_rows_differ": int((kg != kc).sum()),
                           "distinct_matches_cpu": int(np.unique(pc_).size),
                           "min_eig_M_cpu": float(ev[0]),
                           "cond_M_cpu": float(ev[-1] / ev[0]),
                           "C_max_abs": [float(np.abs(Cg).max()),
                                         float(np.abs(Cc).max())],
                           "C_max_diff": float(np.abs(Cg - Cc).max())})
        sign = np.random.default_rng(i).choice([-1.0, 1.0], size=C0.shape)
        C1 = (C0 + sign * np.spacing(np.abs(C0))).astype(np.float32)

        def run(C):
            def on(x):
                return torch.as_tensor(np.asarray(x, np.float32))[None]
            return zoomout_refine(
                on(C), on(ex), on(ey), torch.ones((1, len(ex)), dtype=bool),
                torch.ones((1, len(ey)), dtype=bool), cad_xyz=on(cad["xyz"]),
                pc_xyz=on(pc["xyz"]), diam=torch.tensor([diam]),
                gate_tau=0.15)[0].numpy()
        c_cpu = run(C0)
        out.append({"instance": i, "obj": int(obj["obj_id"]),
                    "ir": float(ref["ir"]), "rounds": rounds,
                    "cpu_matches_trace": bool(np.array_equal(
                        c_cpu, tr["cpu"][-1][4])),
                    "cpu_ulp_moved_C_max_diff": float(np.abs(
                        c_cpu - run(C1)).max())})
    emit("zoomout_sensitivity", gpu=gpu_line, instances=out)


def predictor_candidates(online, model, gpu_line: str) -> None:
    """Predictor(tta_rotations=4, zoomout_k=64, 4096 hypotheses,
    select_trigger=0).predict on the card and on the port's CPU, one
    request on the degraded online frame (seed 3) with the same RANSAC
    draws: the candidate maps, each candidate's filter, RANSAC and
    depth-render score against the frame's depth (K, observed depth,
    mask), the selection and the flip stage. Held: the same winning
    candidate and flip hypothesis, the pose within 1 deg and 1 % of the
    diameter. select_trigger=0 keeps the base map: this frame's base map
    is weak, and at the default trigger every candidate competes on
    correspondences that are mostly wrong, whose ZoomOut refit and
    RANSAC poses move with rounding (zoomout_sensitivity)."""
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.data.synth import default_intrinsics
    f = next(fr for fr in online if fr["degraded"])
    draws = np.random.default_rng(3).random((8, 512, 3), dtype=np.float32)
    res = {}
    for d, m in (("cuda", model), ("cpu", cpu_copy(model))):
        pred = Predictor(m, {f["obj"]: f["cad_ops"]}, mode="online",
                         ransac_hypotheses=4096, tta_rotations=4,
                         zoomout_k=64, select_trigger=0.0, device=d)
        t0 = time.perf_counter()
        out = pred.predict(f["depth"], default_intrinsics(), 1.0,
                           [f["mask"]], [f["obj"]], uniforms=[draws])[0]
        res[d] = dict(out, ms=1e3 * (time.perf_counter() - t0))
    a, b = res["cuda"], res["cpu"]
    dr = rot_deg(a["R"], b["R"])
    dt = float(np.linalg.norm(a["t"] - b["t"]) / f["diam"])
    cand = [int(a["candidate"]), int(b["candidate"])]
    flip = [int(a["flip_hypothesis"]), int(b["flip_hypothesis"])]
    emit("predictor_candidates", obj=f["obj"], gpu=gpu_line,
         candidate=cand, flip_hypothesis=flip, rot_deg=dr, t_frac_diam=dt,
         ms={"cuda": a["ms"], "cpu": b["ms"]},
         rot_err_deg=[rot_deg(x["R"], f["R_gt"]) for x in (a, b)],
         tol="same candidate and flip, 1 deg, 1 % diam",
         timing="host clock around one predict() (first call)")
    if not (cand[0] == cand[1] and flip[0] == flip[1] and dr <= 1.0
            and dt <= 0.01):
        raise AssertionError("Predictor with candidates: card and CPU "
                             "disagree")


def cli_pose(results_dir, avg: str) -> None:
    """python -m pose6d_tpu_torch.cli.pose ransac ... --device cuda
    --no-ply --disambiguate as a subprocess on the same files: its
    avg_results.txt equals the in-process run's."""
    import os
    out_dir = EVAL_DIR / "pose_cli"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pose6d_tpu_torch.cli.pose", "ransac",
         str(results_dir), str(out_dir), "--device", "cuda", "--no-ply",
         "--disambiguate"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    if res.returncode != 0:
        raise AssertionError(f"cli.pose failed:\n{res.stderr[-4000:]}")
    got = (out_dir / "results_poses_RANSAC" / "avg_results.txt").read_text()
    emit("cli_pose", seconds=time.perf_counter() - t0, equal=got == avg,
         ply_dir=(out_dir / "results_poses_RANSAC" / "ply").exists())
    if got != avg:
        raise AssertionError("cli.pose avg_results.txt differs from the "
                             "in-process run's")


# the README's workflow (cli_workflow): two random_shape objects, four
# frames each, lm_synth.yaml's model at full width
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
CLI_CONFIG = str(ROOT / "config" / "lm_synth.yaml")
CLI_NAMES = ("synth_obj1", "synth_obj2")
CLI_STEPS = 8
# result arrays copied from the sample (the cache), equal on both devices
SAMPLE_KEYS = ("K", "R_m2c", "align_pc", "cad_xyz", "diam_cad", "evecs_cad",
               "evecs_pc", "im_hw", "obj_id", "pcd_depth", "t_m2c")


def cli_overrides(cache: str, results: str = "results") -> list:
    return [f"data_root={CLI_DIR / 'data'}", f"cache_dir={CLI_DIR / cache}",
            f"logging_dir={CLI_DIR / 'logs'}",
            f"save_results={CLI_DIR / results}",
            "train_datasets=[" + ", ".join(
                f"{{render_data_name: {n}}}" for n in CLI_NAMES) + "]",
            f"train.batch_size={TRAIN_BATCH}", f"train.max_steps={CLI_STEPS}",
            "train.log_interval=1"]


def gpu_memory_used_mib() -> int:
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])


def run_module(name: str, *args, memory: dict | None = None) -> tuple:
    """python -m pose6d_tpu_torch.cli.<name> as a subprocess (the entry
    point itself); returns (seconds, stdout). With `memory`, the card's
    used memory (nvidia-smi, MiB) before the call and its peak during it,
    sampled every 0.5 s."""
    import os
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        if memory is not None:
            memory["before_mib"] = memory["peak_mib"] = gpu_memory_used_mib()
        proc = subprocess.Popen(
            [sys.executable, "-m", f"pose6d_tpu_torch.cli.{name}",
             *map(str, args)], cwd=ROOT, stdout=out, stderr=err, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > 600:
                    raise AssertionError(f"cli.{name} took over 600 s")
                if memory is not None:
                    memory["peak_mib"] = max(memory["peak_mib"],
                                             gpu_memory_used_mib())
                time.sleep(0.5)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    if proc.returncode != 0:
        raise AssertionError(f"cli.{name} failed ({proc.returncode}):\n"
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
    return time.perf_counter() - t0, stdout


def timed_call(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def cache_agreement(serial, workers) -> dict:
    """The card's cache (the serial build) against the same samples built
    afresh on the CPU and on the card (the cloud: backprojection, outlier
    removal, FPS; the GT pairs and overlaps), every obj array exactly;
    against the cache the parallel workers built on the card (obj files
    exactly, the PC operators' eigenvalues within 1e-3 relative: ARPACK
    starts at random); the shared CAD cache and the card's cache read on
    the CPU equal to the card's reads. Times each fresh sample (PNG
    decoding included; the CAD operators come from the shared cache)."""
    import shutil

    from pose6d_tpu_torch.data.dataset import BOPObjectDataset
    data = CLI_DIR / "data"
    fresh_dirs = {d: CLI_DIR / f"cache_fresh_{d}" for d in ("cuda", "cpu")}
    for d in fresh_dirs.values():
        shutil.copytree(serial / "shared_cad", d / "shared_cad")
    rows, failed, build_ms = [], [], {d: [] for d in fresh_dirs}
    for name in CLI_NAMES:
        card = BOPObjectDataset(data, name, cache_dir=serial, device="cuda")
        shared = BOPObjectDataset(data, name, cache_dir=serial, device="cpu")
        fresh = {d: BOPObjectDataset(data, name, cache_dir=c, lbo_pc=False,
                                     device=d)
                 for d, c in fresh_dirs.items()}
        for k, (i, j) in enumerate(card.mapping_list):
            got = card[k]
            if any(bits_differ(a, b) for a, b in zip(got, shared[k])):
                failed.append(f"{name} {k}: the CPU reads the cache "
                              "differently")
            row = {"dataset": name, "sample": k,
                   "pc_points": len(got[2]["pcd_depth"]),
                   "gt_pairs": len(got[2]["P"])}
            for d, ds in fresh.items():
                s, (cad, _, _) = timed_call(ds.__getitem__, k)
                build_ms[d].append(1e3 * s)
                obj = npz(fresh_dirs[d] / name / "train_pbr"
                          / f"{i}_{j}_obj.npz")
                row[f"fresh_{d}_differs"] = bits_differ(got[2], obj) + [
                    f"cad.{x}" for x in bits_differ(got[0], cad)]
            par = workers / name / "train_pbr"
            row["workers_obj_differs"] = bits_differ(
                got[2], npz(par / f"{i}_{j}_obj.npz"))
            ev = npz(par / f"{i}_{j}_pc_LBO.npz")["evals"]
            row["workers_pc_evals_max_rel_err"] = float(np.max(
                np.abs(ev - got[1]["evals"])
                / np.maximum(np.abs(got[1]["evals"]), 1e-6)))
            rows.append(row)
            if any(row[f"fresh_{d}_differs"] for d in fresh) \
                    or row["workers_obj_differs"] \
                    or row["workers_pc_evals_max_rel_err"] > 1e-3:
                failed.append(f"{name} {k}")
    return {"rows": rows, "failed": failed,
            "fresh_sample_ms": build_ms}


def cli_workflow(gpu_line: str) -> dict:
    """The README's workflow through the port's CLIs on the card, at
    lm_synth.yaml's full width: gen_shapes (a subprocess) -> synth_data
    (2 objects x 4 frames, 640 x 480) -> generate_cache on cuda (in this
    process with --serial, and as a subprocess with its default workers:
    N CUDA contexts on the card) -> train (8 steps at B = 8) -> eval
    --save-results on both sets -> pose ransac (in this process on the
    first set, as a subprocess on the second) -> ir_extraction (a
    subprocess). Launches are counted over the in-process train, eval
    and pose runs, each from 0 (PATH_KERNELS["cli"]).

    Held: the cache against the CPU (cache_agreement); the losses finite
    and falling (mean of the first 3 over the last 3) and
    params_latest.msgpack reloading bit for bit; eval against the port's
    CPU run of the same CLI: the npz layout and the arrays copied from
    the sample on every instance, the IR within 0.01 where the map is
    determined by the eval phase's weak-base rule (the CPU's
    spatial-filter survivors at least select_trigger = 0.25 of the PC
    points; a model 8 steps from its init may leave none, and the rest
    are printed); the
    pose stage against the CPU on the first set's files with GT-derived
    pairs (pose_agreement); ir_extraction's means equal to the eval's
    IRs."""
    import shutil

    from pose6d_tpu_torch.cli import (eval as cli_eval, generate_cache,
                                      ir_extraction, pose, synth_data,
                                      train as cli_train)
    from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    secs, launches = {}, {}
    secs["gen_shapes"], _ = run_module("gen_shapes", CLI_DIR / "models",
                                       "--count", 2, "--seed", 7)
    secs["synth_data"], _ = timed_call(synth_data.main, [
        str(CLI_DIR / "data"), "--models", str(CLI_DIR / "models"),
        "--objects", "1", "2", "--frames", "4", "--seed", "7"])
    cfg = ["--config", CLI_CONFIG]
    secs["generate_cache_serial"], rc = timed_call(generate_cache.main, [
        *cfg, "--device", "cuda", "--serial", *cli_overrides("cache")])
    if rc:
        raise AssertionError("generate_cache --serial: samples failed")
    torch.cuda.empty_cache()     # room for the workers' contexts
    memory = {}
    secs["generate_cache_workers"], out = run_module(
        "generate_cache", *cfg, "--device", "cuda",
        *cli_overrides("cache_workers"), memory=memory)
    workers = int(out.split(" workers on ")[0].rsplit(" ", 1)[1])
    agree = cache_agreement(CLI_DIR / "cache", CLI_DIR / "cache_workers")
    n_samples = len(agree["rows"])
    emit("cli_cache", gpu=gpu_line, samples=n_samples,
         s_per_sample={"serial_cuda": secs["generate_cache_serial"]
                       / n_samples,
                       f"{workers}_workers_cuda":
                       secs["generate_cache_workers"] / n_samples},
         fresh_sample_ms=agree["fresh_sample_ms"],
         workers=workers, workers_gpu_memory=memory,
         card_vs_cpu=agree["rows"],
         note="s per sample: wall of the whole build over its samples "
              "(the workers' run includes spawning them and their CUDA "
              "set-up; the CAD operators are built once per object, by "
              "every worker that needs one before it is cached)",
         tol="points, GT pairs, overlaps and the workers' obj files exact; "
             "the workers' PC eigenvalues 1e-3 relative")
    if agree["failed"]:
        raise AssertionError(f"cli cache: card and CPU disagree on "
                             f"{agree['failed']}")

    reset_launches()
    secs["train"], state = timed_call(cli_train.main, [
        *cfg, "--device", "cuda", *cli_overrides("cache")])
    launches["train"] = dict(LAUNCHES)
    (run,) = (CLI_DIR / "logs").iterdir()
    losses = [r["loss"] for r in map(json.loads, (run / "metrics.jsonl")
                                     .read_text().splitlines())
              if "step" in r]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if len(losses) != CLI_STEPS or not all(map(math.isfinite, losses)) \
            or not last < first:
        raise AssertionError(f"cli train losses {losses}")
    weights = run / "params_latest.msgpack"
    back = load_flax_checkpoint(weights, DPFMNet())
    for name, t in state.model.state_dict().items():
        if not torch.equal(back.state_dict()[name], t.cpu()):
            raise AssertionError(f"params_latest.msgpack differs at {name}")

    ev = [*cfg, "--weights", str(weights), "--save-results", "--eval-names",
          *CLI_NAMES]
    reset_launches()
    secs["eval"], card = timed_call(cli_eval.main, [
        *ev, "--device", "cuda", *cli_overrides("cache")])
    launches["eval"] = dict(LAUNCHES)
    t0 = time.perf_counter()
    cpu = cli_eval.main([*ev, "--device", "cpu",
                         *cli_overrides("cache", "results_cpu")])
    secs["eval_cpu"] = time.perf_counter() - t0
    rows, failed = [], []
    for name in CLI_NAMES:
        for f in sorted((CLI_DIR / "results" / name).glob("result_*.npz")):
            a, b = npz(f), npz(CLI_DIR / "results_cpu" / name / f.name)
            if tuple(sorted(a)) != NPZ_KEYS or sorted(b) != sorted(a):
                raise AssertionError(f"cli eval {f}: keys {sorted(a)}")
            differ = [k for k in SAMPLE_KEYS if bits_differ(
                {k: a[k]}, {k: b[k]})]
            row = {"set": name, "file": f.name, "ir": [float(a["ir"]),
                                                       float(b["ir"])],
                   "survivors": [len(a["p_pred"]), len(b["p_pred"])],
                   "held": len(b["p_pred"]) >= SERVE_TRIGGER * len(
                       b["pcd_depth"]),
                   "p_pred_equal": bool(np.array_equal(a["p_pred"],
                                                       b["p_pred"])),
                   "sample_arrays_differ": differ}
            rows.append(row)
            if differ or (row["held"]
                          and abs(row["ir"][0] - row["ir"][1]) > 0.01):
                failed.append(f"{name}/{f.name}")
    n_inst = len(rows)
    if failed:
        raise AssertionError(f"cli eval: card and CPU disagree on {failed}")

    res = CLI_DIR / "results"
    reset_launches()
    secs["pose"], _ = timed_call(pose.main, [
        "ransac", str(res / CLI_NAMES[0]), str(CLI_DIR / "poses" / "set0"),
        "--device", "cuda"])
    launches["pose"] = dict(LAUNCHES)
    n_pose = len(list((res / CLI_NAMES[0]).glob("result_*.npz")))
    secs["pose_subprocess"], _ = run_module(
        "pose", "ransac", res / CLI_NAMES[1], CLI_DIR / "poses" / "set1",
        "--device", "cuda")
    gt_dir = CLI_DIR / "gt_pairs"
    n_pairs = gt_results(res / CLI_NAMES[0], gt_dir, 0.05)
    sides = {d: run_pose(gt_dir, CLI_DIR / f"pose_gt_{d}", "ransac", d,
                         write_ply=False) for d in ("cuda", "cpu")}
    pose_rows, pose_failed = [], []
    for a, b in zip(sides["cuda"]["chunks"], sides["cpu"]["chunks"]):
        for j, i in enumerate(a["i"]):
            r = eval_results(gt_dir, i)
            reach = float(np.linalg.norm(
                r["cad_xyz"] @ r["R_m2c"].T + r["t_m2c"], axis=1).max())
            row = {"instance": i, "gt_pairs": n_pairs[i],
                   **pose_agreement(a, b, j, float(r["diam_cad"]), reach)}
            pose_rows.append(row)
            if not pose_ok(row):
                pose_failed.append(i)
    if pose_failed:
        raise AssertionError(f"cli pose: card and CPU disagree on "
                             f"{pose_failed} (GT-derived pairs)")
    ir_rows = {}
    for k, name in enumerate(CLI_NAMES):
        txt = CLI_DIR / "poses" / f"set{k}" / "results_poses_RANSAC" / \
            "results"
        s, out = run_module("ir_extraction", txt)
        secs[f"ir_extraction_{k}"] = s
        per_obj = ir_extraction.main([str(txt)])
        # the pose stage writes no txt for an instance without pairs (as
        # the reference does), so those leave the mean
        results = [npz(f) for f in sorted((res / name).glob("result_*.npz"))]
        irs = [float(r["ir"]) for r in results if len(r["p_pred"])]
        ir_rows[name] = {"means": {o: float(np.mean(v))
                                   for o, v in per_obj.items()},
                         "eval_irs_with_pairs": irs,
                         "instances_without_pairs": len(results) - len(irs),
                         "printed": out.strip().splitlines()[0]}
        if [sorted(v) for v in per_obj.values()] != [sorted(irs)]:
            raise AssertionError(f"ir_extraction {name}: {per_obj} vs {irs}")

    counts = {k: sum(c[k] for c in launches.values()) for k in LAUNCHES}
    missing = [n for n in PATH_KERNELS["cli"] if not counts[n]]
    if missing:
        raise AssertionError(f"cli: not launched: {missing} ({launches})")
    emit("cli_workflow", gpu=gpu_line, seconds=secs,
         phase_s=time.perf_counter() - t_phase, samples=n_samples,
         train_losses=losses, train_mean_first3=first, train_mean_last3=last,
         train_ms_per_step=1e3 * secs["train"] / CLI_STEPS,
         eval_ms_per_instance=1e3 * secs["eval"] / n_inst,
         pose_ms_per_instance=1e3 * secs["pose"] / n_pose,
         eval_card_vs_cpu=rows, eval_mean_ir=[c[0] for c in card],
         eval_mean_ir_cpu=[c[0] for c in cpu],
         pose_gt_pairs_card_vs_cpu=pose_rows,
         pose_gt_pairs_ms_per_instance={
             d: v["ms"] / max(v["n"], 1) for d, v in sides.items()},
         ir_extraction=ir_rows,
         launches_per_train_step={k: v / CLI_STEPS for k, v in
                                  launches["train"].items()},
         launches_per_eval_instance={k: v / n_inst for k, v in
                                     launches["eval"].items()},
         launches_per_pose_instance={k: v / n_pose for k, v in
                                     launches["pose"].items()},
         timing="host clock around each CLI call, device synchronised at "
                "its ends; subprocesses include their start-up",
         tol="eval: layout and sample arrays exact everywhere, IR 0.01 "
             "where held (CPU survivors >= 0.25 x PC points); pose on "
             "GT-derived pairs as pose_stage; ir_extraction equal")
    return counts


# resolve's variants in model_selection: (label, flags)
RESOLVE_RUNS = (("topk3", ["--topk", "3"]), ("topk5", ["--topk", "5"]),
                ("topk8", ["--topk", "8"]),
                ("taus", ["--topk", "5", "--taus", "0.35", "0.2", "0.1",
                          "0.12"]),
                ("naive", ["--solver", "naive"]))


def model_selection(gpu_line: str) -> dict:
    """The model-selection and analysis workflow on cli_workflow's run and
    cache (lm_synth.yaml at full width, a checkpoint per step, the last 5
    kept): probe_ckpts over the kept curve on both eval sets; swa of the
    curve on the card and on the CPU; cli.eval with the SWA params on
    the card; resolve of the eval results at top-k 3, 5, 8, at top-k 5
    with another schedule, and naive, on the card and the CPU (copies);
    sym_ir of the card's and the CPU's eval results; visualize corr of
    one result. Each timed (host clock, device synchronised), its
    launches counted from 0; the in-process card runs must launch the
    flash forward, top-k, rank-major and argmin (PATH_KERNELS).

    Held: the SWA params bit for bit (float64 sums on either device);
    on the instances that the eval phase's rule, fixed before the run,
    calls determined (the CPU's survivors at least SERVE_TRIGGER x the
    PC points; the rest printed): resolve's IR within 0.01 and its
    surviving pairs (p_pred, as a set of (CAD, PC) pairs) equal but for
    at most 1 % of the CPU's survivors, and the probe's IR per instance
    within 0.01; sym_ir's per-object IR within 0.01 where every instance
    of the object is determined, its symmetries (host numpy on the same
    CAD) equal. The resolves' card side runs on both eval sets (its
    launches and times), the CPU side on the first.

    Why the pair sets may differ on a determined instance: the top-k
    kernel and its plain version (the JAX package's XLA expansion) round
    a spectral distance differently, so candidates whose distances tie
    to within that rounding swap ranks (p_pred's order) or swap across
    the k-th rank (a pair in or out, and the sums of the pairs near it).
    On an H100 p_pred was unequal on one determined instance of each
    spatial variant: at k = 3 and 5 with the same survivors and IR, at
    k = 8 and the looser schedule 1-2 survivors apart of ~1200-2400."""
    import shutil

    from pose6d_tpu_torch.cli import (eval as cli_eval, probe_ckpts, resolve,
                                      swa, sym_ir, visualize)
    from pose6d_tpu_torch.config import load_config
    from pose6d_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    t_phase = time.perf_counter()
    (run,) = (CLI_DIR / "logs").iterdir()
    steps = [swa.checkpoint_step(c) for c in swa.select_paths(run)]
    cfg = load_config(CLI_CONFIG, cli_overrides("cache"))
    secs, launches, failed = {}, {}, []

    def counted(label, fn, *args):
        reset_launches()
        secs[label], out = timed_call(fn, *args)
        launches[label] = dict(LAUNCHES)
        return out

    inst = {"cuda": [], "cpu": []}
    recs = counted("probe_ckpts", probe_ckpts.probe, cfg, run, CLI_NAMES, 1,
                   0, None, "cuda", None, inst["cuda"])
    t0 = time.perf_counter()
    probe_ckpts.probe(cfg, run, CLI_NAMES, 1, steps[-1], None, "cpu", None,
                      inst["cpu"])
    secs["probe_ckpts_cpu_last_step"] = time.perf_counter() - t0
    probe_rows = []
    last = [r for r in inst["cuda"] if r["step"] == steps[-1]]
    for a, b in zip(last, inst["cpu"]):
        held = b["survivors"] >= SERVE_TRIGGER * b["pc_points"]
        probe_rows.append({"set": a["set"], "ir": [a["ir"], b["ir"]],
                           "survivors": [a["survivors"], b["survivors"]],
                           "held": held})
        if held and abs(a["ir"] - b["ir"]) > 0.01:
            failed.append(f"probe step {steps[-1]} {a['set']}")

    swa_files = {d: CLI_DIR / f"swa_{d}.msgpack" for d in ("cuda", "cpu")}
    counted("swa", swa.main, ["--run", str(run), "--out",
                              str(swa_files["cuda"]), "--device", "cuda"])
    swa.main(["--run", str(run), "--out", str(swa_files["cpu"]), "--device",
              "cpu"])
    swa_equal = swa_files["cuda"].read_bytes() == \
        swa_files["cpu"].read_bytes()
    if not swa_equal:
        failed.append("swa params")
    swa_eval = counted("eval_swa", cli_eval.main, [
        "--config", CLI_CONFIG, "--weights", str(swa_files["cuda"]),
        "--save-results", "--eval-names", *CLI_NAMES, "--device", "cuda",
        *cli_overrides("cache", "results_swa")])

    resolve_rows = {}
    for label, flags in RESOLVE_RUNS:
        dirs = {d: CLI_DIR / f"resolve_{label}_{d}" for d in ("cuda", "cpu")}
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(CLI_DIR / "results", d)
        reset_launches()
        t0 = time.perf_counter()
        for name in CLI_NAMES:
            resolve.main([str(dirs["cuda"] / name), "--device", "cuda",
                          *flags])
        torch.cuda.synchronize()
        secs[f"resolve_{label}"] = time.perf_counter() - t0
        launches[f"resolve_{label}"] = dict(LAUNCHES)
        name = CLI_NAMES[0]
        t0 = time.perf_counter()
        resolve.main([str(dirs["cpu"] / name), "--device", "cpu", *flags])
        secs[f"resolve_{label}_cpu_first_set"] = time.perf_counter() - t0
        rows = []
        for f in sorted((dirs["cpu"] / name).glob("result_*.npz")):
            a, b = npz(dirs["cuda"] / name / f.name), npz(f)
            held = len(b["p_pred"]) >= SERVE_TRIGGER * len(b["pcd_depth"])
            pa = set(map(tuple, a["p_pred"].tolist()))
            pb = set(map(tuple, b["p_pred"].tolist()))
            row = {"set": name, "file": f.name,
                   "ir": [float(a["ir"]), float(b["ir"])],
                   "survivors": [len(a["p_pred"]), len(b["p_pred"])],
                   "held": held,
                   "p_pred_equal": bool(np.array_equal(a["p_pred"],
                                                       b["p_pred"])),
                   "pairs_only_card": len(pa - pb),
                   "pairs_only_cpu": len(pb - pa)}
            rows.append(row)
            if held and (len(pa ^ pb) > 0.01 * len(pb)
                         or abs(row["ir"][0] - row["ir"][1]) > 0.01):
                failed.append(f"resolve {label} {name}/{f.name}")
        resolve_rows[label] = rows

    sym = {}
    for name in CLI_NAMES:
        t0 = time.perf_counter()
        card = sym_ir.main([str(CLI_DIR / "results" / name), "--out",
                            str(CLI_DIR / f"sym_ir_{name}.json")])
        secs[f"sym_ir_{name}"] = time.perf_counter() - t0
        cpu = sym_ir.analyze(CLI_DIR / "results_cpu" / name)
        held_files = [f for f in sorted((CLI_DIR / "results_cpu" / name)
                                        .glob("result_*.npz"))
                      if len(npz(f)["p_pred"]) >= SERVE_TRIGGER * len(
                          npz(f)["pcd_depth"])]
        n_files = len(list((CLI_DIR / "results_cpu" / name).glob(
            "result_*.npz")))
        all_held = len(held_files) == n_files
        sym[name] = {"card": card, "cpu": cpu, "held": all_held}
        if card.keys() != cpu.keys() or any(
                card[o]["symmetries"] != cpu[o]["symmetries"] for o in card):
            failed.append(f"sym_ir {name}: symmetries differ")
        if all_held and any(abs(card[o][k] - cpu[o][k]) > 0.01
                            for o in card for k in ("ir", "sym_ir")):
            failed.append(f"sym_ir {name}")
    one = sorted((CLI_DIR / "results" / CLI_NAMES[0]).glob("result_*.npz"))[0]
    t0 = time.perf_counter()
    visualize.main(["corr", str(one), str(CLI_DIR / "visualize")])
    secs["visualize_corr"] = time.perf_counter() - t0
    plys = sorted(p.name for p in (CLI_DIR / "visualize").glob("*.ply"))
    if plys != ["cad.ply", "correspondences.ply", "pc_aligned.ply"]:
        failed.append(f"visualize corr wrote {plys}")

    counts = {k: sum(c[k] for c in launches.values()) for k in LAUNCHES}
    missing = [n for n in PATH_KERNELS["model_selection"] if not counts[n]]
    emit("model_selection", gpu=gpu_line, seconds=secs,
         phase_s=time.perf_counter() - t_phase, checkpoints=steps,
         probe=recs, probe_card_vs_cpu_last_step=probe_rows,
         swa_card_equals_cpu=swa_equal,
         eval_swa_mean_ir=[c[0] for c in swa_eval],
         resolve_card_vs_cpu=resolve_rows, sym_ir=sym,
         visualize_corr=plys, launches=launches,
         timing="host clock around each call, device synchronised at its "
                "ends",
         tol="swa bit for bit; where held (CPU survivors >= 0.25 x PC "
             "points): resolve IR 0.01 and pair sets equal but for 1 % of "
             "the CPU's survivors (top-k near-ties), probe IR 0.01; sym_ir "
             "IR 0.01 where every instance is held")
    if failed or missing:
        raise AssertionError(f"model_selection: disagree on {failed}, not "
                             f"launched {missing}")
    return counts


def train_repeat(gpu_line: str) -> None:
    """train() twice with one seed on one cache (cli_workflow's), 8 steps
    at B = 8 and lm_synth.yaml's full width: the two runs' losses and
    final parameters (params_latest.msgpack) equal bit for bit. Then, to
    name the op that parted the runs before, two more runs with the
    NCE's feature gather back on torch.gather's own backward (atomics):
    printed, not held."""
    from pose6d_tpu_torch.cli import train as cli_train
    from pose6d_tpu_torch.train import loss

    def two_runs(tag):
        runs, secs = [], []
        for r in range(2):
            logs = CLI_DIR / f"repeat_{tag}_{r}"
            s, _ = timed_call(cli_train.main, [
                "--config", CLI_CONFIG, "--device", "cuda",
                *cli_overrides("cache"), f"logging_dir={logs}"])
            (run,) = logs.iterdir()
            losses = [rec["loss"] for rec in map(json.loads, (
                run / "metrics.jsonl").read_text().splitlines())
                if "step" in rec]
            runs.append((losses, (run / "params_latest.msgpack")
                         .read_bytes()))
            secs.append(s)
        return runs, secs

    runs, secs = two_runs("fixed_order")
    same_loss = runs[0][0] == runs[1][0]
    same_params = runs[0][1] == runs[1][1]
    fixed_order = loss.gather_rows
    loss.gather_rows = lambda x, idx: torch.gather(
        x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    try:
        atomic, _ = two_runs("torch_gather")
    finally:
        loss.gather_rows = fixed_order
    emit("train_repeat", gpu=gpu_line, seconds=secs,
         losses=[r[0] for r in runs], losses_equal=same_loss,
         params_equal=same_params,
         torch_gather_losses=[r[0] for r in atomic],
         torch_gather_params_equal=atomic[0][1] == atomic[1][1],
         note="two cli.train runs, one seed, one cache, the NCE gather's "
              "backward a fixed-order sum (train/loss.gather_rows); then "
              "two with torch.gather's backward (printed, not held)")
    if not (same_loss and same_params and len(runs[0][0]) == CLI_STEPS):
        raise AssertionError("train_repeat: the two runs differ")


def online_grouped_fps(frames, model, stages, gpu_line: str) -> None:
    """The two online frames through Predictor(fps_groups=8) on the card
    (a warm-up round, then a timed one): grouped FPS picks on the card
    equal to the CPU's on the same cloud (online_stages' backprojected
    points and keep mask, exact against the CPU's already); the FPS
    stage's device ms grouped against exact (CUDA events) and both
    covering radii."""
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.data.synth import default_intrinsics
    from pose6d_tpu_torch.ops import sampling
    bank = {f["obj"]: f["cad_ops"] for f in frames}
    pred = Predictor(model, bank, mode="online", device="cuda", fps_groups=8)
    K = default_intrinsics()
    rng = np.random.default_rng(2)
    for rnd in range(2):
        for f in frames:
            draws = rng.random((ONLINE_DRAW_BLOCKS, 512, 3), dtype=np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred.predict(f["depth"], K, 1.0, [f["mask"]], [f["obj"]],
                               uniforms=[draws])[0]
            ms = 1e3 * (time.perf_counter() - t0)
            if rnd == 0:
                continue
            st = stages[f["obj"]]
            pts, keep = st["pts"][None], st["keep"][None]
            gp, gk = pts.cuda(), keep.cuda()
            with torch.inference_mode():
                idx_c, sel_c = sampling.farthest_point_sample_grouped(
                    pts, keep, pred.max_pc, groups=8)
                idx_g, sel_g = sampling.farthest_point_sample_grouped(
                    gp, gk, pred.max_pc, groups=8)
                grouped_ms = cuda_ms(lambda: sampling.
                                     farthest_point_sample_grouped(
                                         gp, gk, pred.max_pc, groups=8), 2)
                exact_ms = cuda_ms(lambda: sampling.farthest_point_sample(
                    gp, gk, pred.max_pc), 2)
            equal = torch.equal(idx_g.cpu(), idx_c) and \
                torch.equal(sel_g.cpu(), sel_c)
            emit("online_grouped_fps", obj=f["obj"], gpu=gpu_line,
                 request_ms=ms, fps_ms={"grouped_8": grouped_ms,
                                        "exact": exact_ms},
                 covering_radius_cm={
                     "grouped_8": covering_radius(st["pts"], st["keep"],
                                                  idx_c[0][sel_c[0]]),
                     "exact": covering_radius(st["pts"], st["keep"],
                                              st["idx"][st["sel"]])},
                 picks_card_equal_cpu=equal,
                 sampled_points=int(sel_c.sum()),
                 n_inliers=int(out["n_inliers"]),
                 timing="request: host clock around a synchronised "
                        "predict(); fps: CUDA events around the sampler "
                        "alone, 2 calls")
            if not equal:
                raise AssertionError(f"grouped FPS: card and CPU picks "
                                     f"differ on obj {f['obj']}")


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
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
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
    emit("sass", **sass_loop_counts())

    online = render_online_frames()
    emit("online_frames", objects=[f["obj"] for f in online],
         degraded=[f["degraded"] for f in online],
         masked_pixels=[int(f["mask"].sum()) for f in online],
         eroded_mask_pixels=[f["eroded_pixels"] for f in online],
         cad_points=[len(f["cad_ops"]["xyz"]) for f in online],
         diam_cm=[f["diam"] for f in online],
         operators_s=[f["ops_s"] for f in online])
    model = load_flax_checkpoint(ROOT / "weights" / "synth_seen.msgpack",
                                 DPFMNet()).to(dev).eval()
    pred, draws, results, stages, paths_online = online_request(
        online, model, gpu_line)
    online_cpu_agreement(online, model, pred, draws, results, stages)
    online_grouped_fps(online, model, stages, gpu_line)
    disambiguation_batch(online, model, pred, stages, dev, gpu_line)

    frames = load_frames()
    emit("frames", objects=[f["obj"] for f in frames],
         cad_points=[len(f["cad_ops"]["xyz"]) for f in frames],
         pc_points=[len(f["pc_ops"]["xyz"]) for f in frames],
         operators_s=[f["ops_s"] for f in frames],
         note="the PLYs carry no faces: the CAD operators are point-cloud "
              "operators too (k_eig 64)")
    paths = {"online": paths_online, "serve": serve(frames, model, dev)}
    batch_throughput(frames, model, dev, gpu_line)
    paths["pc_major_filter"] = pc_major_filter(frames, model, dev, gpu_line)
    items = training_items(frames)
    train_check(items, dev)
    paths["train"] = train_run(items, dev, gpu_line)
    paths["variants"] = variants_phase(variant_items(items, frames), dev,
                                       gpu_line)
    paths["variant_serve"] = variant_serve(online, frames, gpu_line)
    eval_items = eval_dataset(frames, online, stages)
    results_dir, paths["eval"] = eval_phase(eval_items, model, gpu_line)
    paths["pose_stage"], avg = pose_stage_runs(results_dir, gpu_line)
    cli_pose(results_dir, avg)
    paths["cli"] = cli_workflow(gpu_line)
    paths["model_selection"] = model_selection(gpu_line)
    train_repeat(gpu_line)
    zoomout_check(frames, dev, gpu_line)
    zoomout_sensitivity(eval_items, gpu_line)
    predictor_candidates(online, model, gpu_line)
    emit("online_profile", obj=online[0]["obj"], gpu=gpu_line,
         **online_profile(pred, online[0], draws,
                          results[online[0]["obj"]]["ms"]))

    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    line = []
    for name, row in rows.items():
        by_path = {p: c[name] for p, c in paths.items()
                   if name in PATH_KERNELS[p]}
        line.append({"name": name, "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     **{k: row[k] for k in keys},
                     **{k: row[k] for k in ("b1", "c64", "call_ms",
                                            "bound_tc_ms", "instances",
                                            "by_k")
                        if k in row}})
    print(json.dumps({"kernels": line}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
