"""Small host-side utilities (a copy of pose6d_tpu/utils/misc.py, which
uses numpy only; the reference's utils/utils.py)."""
from __future__ import annotations

import numpy as np


def quaternion_rotation_matrix(Q):
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix (reference
    utils/utils.py:13-52 convention)."""
    q0, q1, q2, q3 = Q
    return np.array([
        [2 * (q0 * q0 + q1 * q1) - 1, 2 * (q1 * q2 - q0 * q3),
         2 * (q1 * q3 + q0 * q2)],
        [2 * (q1 * q2 + q0 * q3), 2 * (q0 * q0 + q2 * q2) - 1,
         2 * (q2 * q3 - q0 * q1)],
        [2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1),
         2 * (q0 * q0 + q3 * q3) - 1],
    ])


def inject_incorrect_correspondences(P, M, rng=None):
    """Append M uniformly-random (cad_idx, pc_idx) correspondences to an
    (N, 2) index-pair array — the reference's manual fault-injection
    probe (scripts/test_RANSAC.py:120-132), used to measure solver
    robustness as a function of injected-outlier fraction
    (tests/test_robustness_probe.py, scripts/robustness_curve.py).
    Index ranges follow the reference: max index + 1 per column.
    """
    P = np.asarray(P)
    rng = rng or np.random.default_rng(0)
    num_vertices = int(P[:, 0].max()) + 1
    num_points = int(P[:, 1].max()) + 1
    bad = np.stack([rng.integers(0, num_vertices, M),
                    rng.integers(0, num_points, M)], axis=1)
    return np.concatenate([P, bad], axis=0)
