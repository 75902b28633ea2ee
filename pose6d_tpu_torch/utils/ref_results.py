"""Reader for the reference's per-instance pose-result txt format (a copy
of pose6d_tpu/utils/ref_results.py).

The reference's pose stage (scripts/test_RANSAC.py:241-275
write_results_to_txt) emits one txt per (object, frame) with scalar
metrics and the T_gt / T_pred / T_pred_ICP 4x4 matrices; this repo's
train/pose_stage.py writes the same format. This parser round-trips
both, and powers the direct numerical-parity tests against the
reference's committed result trees (results_on_pbr/...).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

_FLOAT = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"

_SCALARS = {
    "obj_id": r"Object ID:\s*(" + _FLOAT + ")",
    "ir": r"Inlier ration of P_pred:\s*(" + _FLOAT + ")",
    "n_corr": r"Num\. of correspondences:\s*(" + _FLOAT + ")",
    "add": r"Avg\. Euclidean Distance \(ADD\) \[cm\]:\s*(" + _FLOAT + ")",
    "add_score": r"Add Score thres:\s*(" + _FLOAT + ")",
    "add_score_xyz": r"Add Score thres \(xyz direction\):\s*("
                     + _FLOAT + ")",
    "adds_score": r"Add-S Score:\s*(" + _FLOAT + ")",
    "add_icp": r"Avg\. Euclidean Distance \(ADD\) ICP:\s*(" + _FLOAT + ")",
    "adds_score_icp": r"Add-S Score ICP:\s*(" + _FLOAT + ")",
    "error_cm": r"Error \[cm\]:\s*(" + _FLOAT + ")",
    "error_deg": r"Error \[deg\]:\s*(" + _FLOAT + ")",
}

_MATRICES = ("T_gt", "T_pred", "T_pred_ICP")


def _parse_matrix(chunk: str) -> np.ndarray:
    vals = [float(x) for x in re.findall(_FLOAT, chunk)]
    if len(vals) < 16:
        raise ValueError(f"expected 16 matrix entries, got {len(vals)}")
    return np.asarray(vals[:16], np.float64).reshape(4, 4)


def parse_result_txt(path) -> dict:
    """Parse one reference-format result txt into a dict of scalars and
    (4, 4) float64 matrices (keys: T_gt, T_pred, T_pred_ICP)."""
    text = Path(path).read_text()
    out = {}
    for key, pat in _SCALARS.items():
        m = re.search(pat, text)
        if m:
            out[key] = float(m.group(1))
    if "obj_id" in out:
        out["obj_id"] = int(out["obj_id"])
    # matrices: split on the section headers, floats between them
    positions = []
    for name in _MATRICES:
        m = re.search(re.escape(name) + r" \(", text)
        positions.append((name, m.start() if m else None))
    for i, (name, start) in enumerate(positions):
        if start is None:
            continue
        end = None
        for _, nxt in positions[i + 1:]:
            if nxt is not None:
                end = nxt
                break
        out[name] = _parse_matrix(text[start:end])
    return out


def load_result_dir(results_dir) -> list[dict]:
    """Parse every obj_*_result_*.txt in a directory; adds 'path'."""
    out = []
    for p in sorted(Path(results_dir).glob("obj_*_result_*.txt")):
        try:
            d = parse_result_txt(p)
        except (ValueError, OSError):
            continue
        d["path"] = str(p)
        out.append(d)
    return out
