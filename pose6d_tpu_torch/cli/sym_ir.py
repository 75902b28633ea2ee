"""Symmetry-aware inlier-ratio report over an eval results directory (a
copy of pose6d_tpu/cli/sym_ir.py).

Post-processes the eval handoff npzs (train/eval_loop.py exports):
detects each object's approximate rotational symmetries from its CAD
vertices (ops/symmetry.py), then reports per-object plain IR alongside
the symmetry-aware IR that credits correspondences landing on a
symmetry image of the GT point. Complements the reference's
ir_extraction.py aggregation (which this repo mirrors in
cli/ir_extraction.py) with the analysis the round-3/4 record motivates:
on near-symmetric objects the plain IR under-reports map quality in a
way no geometry-only method can resolve.

    python -m pose6d_tpu_torch.cli.sym_ir <results_npz_dir> [--rel-tau 0.02]
        [--out report.json]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..ops.symmetry import detect_symmetries, sym_inlier_ratio


def analyze(results_dir, rel_tau: float = 0.02):
    """Returns {obj_id: {n, ir, sym_ir, symmetries: [...]}} over all
    result_*.npz files in results_dir."""
    by_obj = defaultdict(list)
    for f in sorted(Path(results_dir).glob("**/result_*.npz")):
        by_obj[int(np.load(f)["obj_id"])].append(f)
    report = {}
    for obj, files in sorted(by_obj.items()):
        first = np.load(files[0])
        Rs, sym_report = detect_symmetries(first["cad_xyz"],
                                           rel_tau=rel_tau)
        irs, sym_irs = [], []
        for f in files:
            d = np.load(f)
            thr = 0.1 * float(d["diam_cad"])
            cad, pc = d["cad_xyz"], d["align_pc"]
            eye = np.eye(3, dtype=np.float32)[None]
            irs.append(sym_inlier_ratio(d["p_pred"], cad, pc, thr, eye))
            sym_irs.append(sym_inlier_ratio(d["p_pred"], cad, pc, thr,
                                            Rs))
        report[obj] = {
            "n": len(files),
            "ir": float(np.mean(irs)),
            "sym_ir": float(np.mean(sym_irs)),
            "n_sym_rotations": int(len(Rs) - 1),
            "symmetries": [
                {"order": s["order"], "continuous": bool(s["continuous"]),
                 "residual_rel": round(s["residual_rel"], 4),
                 "axis": [round(float(x), 4) for x in s["axis"]]}
                for s in sym_report],
        }
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_dir")
    p.add_argument("--rel-tau", type=float, default=0.02,
                   help="symmetry acceptance: mean NN residual of the "
                        "rotated model, relative to its diameter")
    p.add_argument("--out", help="also write the report as JSON")
    args = p.parse_args(argv)
    report = analyze(args.results_dir, rel_tau=args.rel_tau)
    if not report:
        print("no result npzs found")
        return report
    print(f"{'obj':>6} {'n':>4} {'IR':>8} {'sym-IR':>8} "
          f"{'rot':>4}  symmetries")
    for obj, r in report.items():
        desc = ", ".join(
            ("cont" if s["continuous"] else f"C{s['order']}")
            + f"(res {s['residual_rel']})" for s in r["symmetries"]) \
            or "-"
        print(f"obj_{obj:>2} {r['n']:>4} {r['ir']:>8.4f} "
              f"{r['sym_ir']:>8.4f} {r['n_sym_rotations']:>4}  {desc}")
    means = {k: float(np.mean([r[k] for r in report.values()]))
             for k in ("ir", "sym_ir")}
    print(f"  mean {means['ir']:>13.4f} {means['sym_ir']:>8.4f}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"per_object": {str(k): v for k, v in report.items()},
             "mean": means, "rel_tau": args.rel_tau}, indent=1))
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
