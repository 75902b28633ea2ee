"""Host-side spectral operators of a point cloud (copy of
point_cloud_operators from pose6d_tpu/spectral/operators.py, without the
gradient operators, which the default model does not use)."""
from __future__ import annotations

import numpy as np

from . import laplacian as lap


def point_cloud_operators(points: np.ndarray, k_eig: int = 64,
                          k_nn: int = 30) -> dict:
    """{xyz (V, 3), mass (V,), evals (k_eig,), evecs (V, k_eig)}, f32."""
    points = np.asarray(points, np.float64)
    L, mass, _, _ = lap.point_cloud_laplacian(points, k=k_nn)
    evals, evecs = lap.laplacian_eigenbasis(L, mass, k_eig)
    return {"xyz": points.astype(np.float32),
            "mass": mass.astype(np.float32), "evals": evals, "evecs": evecs}
