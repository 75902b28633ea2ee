"""Depth frame -> partial cloud: backprojection of the masked pixels and
exact farthest-point sampling, in numpy.

Frozen restatement of what pose6d_tpu_torch/ops/geometry.backproject_depth
and ops/sampling.farthest_point_sample do at commit 653f5ea (pixel (i, j)
-> [(j - cx) z / fx, (i - cy) z / fy, z] in the pipeline's centimetres;
FPS from the first point, the first index on ties), without the mask
erosion and the outlier removal, which the cached-operator path never
sees.
"""
from __future__ import annotations

import numpy as np

from .render import CX, CY, FX, FY


def backproject(depth_mm: np.ndarray) -> np.ndarray:
    """(H, W) depth in mm, 0 where empty -> (N, 3) f64 points in cm, in
    row-major pixel order."""
    ys, xs = np.nonzero(depth_mm > 0)
    z = depth_mm[ys, xs].astype(np.float64)
    pts = np.stack([(xs - CX) * z / FX, (ys - CY) * z / FY, z], axis=1)
    return pts * 0.1


def farthest_point_sample(points: np.ndarray, n: int) -> np.ndarray:
    """Indices of n farthest-point picks (all points when there are
    fewer)."""
    m = len(points)
    if m <= n:
        return np.arange(m)
    idx = np.zeros(n, np.int64)
    min_d = np.full(m, np.inf)
    last = 0
    for i in range(1, n):
        d = np.sum((points - points[last]) ** 2, axis=1)
        np.minimum(min_d, d, out=min_d)
        last = int(np.argmax(min_d))
        idx[i] = last
    return idx
