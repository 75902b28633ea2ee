"""Checkpoint-curve probe: held-out IR for every kept checkpoint (port of
pose6d_tpu/cli/probe_ckpts.py).

Post-hoc early stopping. The train loop keeps the whole checkpoint curve
(train.checkpoint_keep); this command sweeps it against one or more
held-out eval sets and reports mean and per-object IR per step, so the
peak checkpoint is selected on held-out data instead of train loss.

    python -m pose6d_tpu_torch.cli.probe_ckpts --config config/unseen_lm300.yaml \
        --run <logging_dir>/<run> --eval-names synth_eval_obj5 synth_eval_obj6 \
        --out probe.jsonl [--every 2] [--min-step 0] [--device cpu]

Reads the ckpt/ckpt_*.pt files that the port's train() keeps (the JAX
command reads its ckpt_*.msgpack train states). The eval batches are
built once on the device; each checkpoint's model state is loaded into
one model, which runs the eval forward -> the eval solver -> IR. Prints
one JSON record per checkpoint ({"step", "mean_ir", "per_obj"}), appends
them to --out, then the best step.
"""
from __future__ import annotations

import dataclasses
import json

from ._common import base_parser, load


def probe(cfg, run, eval_names, every: int = 1, min_step: int = 0,
          sample_kw: dict | None = None, device="cuda", out=None,
          instances: list | None = None) -> list:
    """The JSONL records of the sweep (the best_step record last); `out`
    is an open text file the records are appended to, or None. A list
    `instances` receives one dict per (checkpoint, eval sample): step,
    set, IR, the solver's surviving pairs and the sample's PC points."""
    from pathlib import Path

    import torch

    from ..data.pipeline import HostLoader, to_device
    from ..models import DPFMNet
    from ..runtime import resolve_device
    from ..train.eval_loop import build_eval_dataset, make_eval_fns
    from .swa import checkpoint_step, load_model_state

    dev = resolve_device(device)
    ckpts = sorted(Path(run).glob("ckpt/ckpt_*.pt"))
    ckpts = [c for c in ckpts if checkpoint_step(c) >= min_step][::every]
    if not ckpts:
        raise SystemExit(f"no checkpoints under {run}/ckpt")
    kw = {"v_cad": cfg.pad_v_cad, "v_pc": cfg.pad_v_pc}
    kw.update(sample_kw or {})
    # every eval batch on the device once, reused for each checkpoint
    cached = []
    for name in eval_names:
        c = dataclasses.replace(cfg, eval_dataset=dataclasses.replace(
            cfg.eval_dataset, render_data_name=name))
        loader = HostLoader(build_eval_dataset(c, device=dev),
                            cfg.eval.batch_size, shuffle=False,
                            drop_last=False, **kw)
        cached += [(name, to_device(b, dev)) for b in loader]

    model = DPFMNet(cfg.model).to(dev).eval()
    fwd, solver, ir_fn = make_eval_fns(
        model, cfg.eval.solver == "spatial_filtering")
    n_fmap = cfg.model.n_fmap
    records, best = [], (-1.0, None)
    for c in ckpts:
        step = checkpoint_step(c)
        model.load_state_dict(load_model_state(c), strict=True)
        per_obj_sum, per_obj_cnt = {}, {}
        with torch.inference_mode():
            for name, batch in cached:
                o = fwd(batch["cad"], batch["pc"])
                pairs, pvalid = solver(
                    o["C"], batch["cad"]["evecs"][..., :n_fmap],
                    batch["pc"]["evecs"][..., :n_fmap], batch["cad"]["xyz"],
                    batch["pc"]["xyz"], batch["cad"]["valid"],
                    batch["pc"]["valid"], batch["diam_cad"])
                irs = ir_fn(pairs, pvalid, batch["cad"]["xyz"],
                            batch["align_pc"],
                            0.1 * batch["diam_cad"]).cpu().numpy()
                if instances is not None:
                    kept = pvalid.sum(-1).tolist()
                    points = batch["pc"]["valid"].sum(-1).tolist()
                    instances += [{"step": step, "set": name,
                                   "ir": float(irs[b]), "survivors": kept[b],
                                   "pc_points": points[b]}
                                  for b in range(len(kept))]
                for b, obj in enumerate(batch["obj_id"].cpu().tolist()):
                    per_obj_sum[obj] = per_obj_sum.get(obj, 0.0) + float(
                        irs[b])
                    per_obj_cnt[obj] = per_obj_cnt.get(obj, 0) + 1
        per_obj = {f"obj_{k}": per_obj_sum[k] / per_obj_cnt[k]
                   for k in sorted(per_obj_sum)}
        mean_ir = sum(per_obj_sum.values()) / sum(per_obj_cnt.values())
        rec = {"step": step, "mean_ir": round(mean_ir, 4),
               "per_obj": {k: round(v, 4) for k, v in per_obj.items()}}
        records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        if mean_ir > best[0]:
            best = (mean_ir, step)
    print(f"BEST step {best[1]} mean_ir {best[0]:.4f}", flush=True)
    records.append({"best_step": best[1], "best_mean_ir": round(best[0], 4)})
    if out:
        out.write(json.dumps(records[-1]) + "\n")
    return records


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--run", required=True,
                   help="train run dir containing ckpt/ckpt_*.pt")
    p.add_argument("--eval-names", nargs="+", required=True,
                   help="eval dataset render_data_name values to probe")
    p.add_argument("--out", default=None, help="JSONL output path")
    p.add_argument("--every", type=int, default=1,
                   help="probe every Nth kept checkpoint")
    p.add_argument("--min-step", type=int, default=0)
    p.add_argument("--pad-cad", type=int, default=None,
                   help="override CAD pad size (small fixtures / tests)")
    p.add_argument("--pad-pc", type=int, default=None)
    args = p.parse_args(argv)
    # argparse's greedy nargs='+' swallows trailing positional overrides;
    # reroute anything with '=' (as cli/eval.py does)
    moved = [n for n in args.eval_names if "=" in n]
    args.eval_names = [n for n in args.eval_names if "=" not in n]
    args.overrides = list(args.overrides) + moved
    cfg = load(args)
    sample_kw = {}
    if args.pad_cad:
        sample_kw["v_cad"] = args.pad_cad
    if args.pad_pc:
        sample_kw["v_pc"] = args.pad_pc
    out = open(args.out, "a") if args.out else None
    try:
        return probe(cfg, args.run, args.eval_names, args.every,
                     args.min_step, sample_kw, args.device, out)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
