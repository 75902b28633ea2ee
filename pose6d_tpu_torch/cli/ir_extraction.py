"""Aggregate inlier ratios from pose-stage txt outputs (a copy of
pose6d_tpu/cli/ir_extraction.py; the reference's
scripts/ir_extraction.py).

    python -m pose6d_tpu_torch.cli.ir_extraction <results_dir>
"""
from __future__ import annotations

import argparse
import re
from collections import defaultdict
from pathlib import Path

import numpy as np

PATTERN = re.compile(r"Inlier ration of P_pred:\s*([0-9.eE+-]+)")
OBJ_PATTERN = re.compile(r"obj_(\d+)_result")


def calculate_average_inlier_ratio(results_dir):
    per_obj = defaultdict(list)
    for f in sorted(Path(results_dir).glob("*.txt")):
        m = PATTERN.search(f.read_text())
        if not m:
            continue
        obj = OBJ_PATTERN.search(f.name)
        per_obj[int(obj.group(1)) if obj else -1].append(float(m.group(1)))
    return per_obj


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results_dir")
    args = p.parse_args(argv)
    per_obj = calculate_average_inlier_ratio(args.results_dir)
    allv = [v for vs in per_obj.values() for v in vs]
    if not allv:
        print("no inlier ratios found")
        return per_obj
    print(f"overall mean IR: {np.mean(allv):.4f} (n={len(allv)})")
    for k in sorted(per_obj):
        print(f"  obj_{k}: {np.mean(per_obj[k]):.4f} (n={len(per_obj[k])})")
    return per_obj


if __name__ == "__main__":
    main()
