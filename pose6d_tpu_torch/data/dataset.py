"""GT supervision of a frame with a known pose (port of the GT part of
pose6d_tpu/data/dataset.py, BOPObjectDataset.__getitem__ :313-337 and
_gt_correspondences :162-187).

The BOP dataset itself (scene reading, preprocessing, the LBO cache)
is not ported yet (ROADMAP, modules still to port). A training dataset
for the port is any sequence of (cad_ops, pc_ops, obj) triples, with
obj as gt_object builds it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.geometry import overlap_from_mask, radius_correspondence_mask


class SampleDropped(Exception):
    """Raised by a dataset when a sample fails preprocessing; the loader
    substitutes the next sample (as the JAX package's loader does)."""


def gt_correspondences(cad_xyz, align_pc, radius: float):
    """GT pairs within `radius` of CAD points and the GT-aligned cloud.

    cad_xyz (V1, 3), align_pc (V2, 3) host arrays (compared in f32).
    Returns pairs (N, 2) int64 [cad_idx, pc_idx] in row-major order,
    overlap_12 (V1,) int8, overlap_21 (V2,) int8.
    """
    cad = torch.as_tensor(np.asarray(cad_xyz, np.float32))
    pc = torch.as_tensor(np.asarray(align_pc, np.float32))
    m = radius_correspondence_mask(
        cad, torch.ones(len(cad), dtype=torch.bool), pc,
        torch.ones(len(pc), dtype=torch.bool), float(radius))
    o12, o21 = overlap_from_mask(m)
    return (torch.nonzero(m).numpy().astype(np.int64),
            o12.numpy().astype(np.int8), o21.numpy().astype(np.int8))


def gt_object(cad_xyz, pc, R, t, diam: float, obj_id: int,
              visib_fract: float = 1.0, K=None, im_hw=None) -> dict:
    """The obj dict that data.pipeline.make_sample reads, for an observed
    cloud pc (N, 3) in the camera frame and the model-to-camera pose
    (R (3, 3), t (3,), pipeline units), GT pairs at 0.05 * diam."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    t = np.asarray(t, np.float64).reshape(3)
    # GT-aligned cloud in the model frame (dataset.py:318)
    align_pc = (np.asarray(pc, np.float64) - t.reshape(1, 3)) @ R
    pairs, o12, o21 = gt_correspondences(cad_xyz, align_pc, diam * 0.05)
    obj = {
        "visib_fract": visib_fract,
        "R_m2c": R.astype(np.float32),
        "t_m2c": t.astype(np.float32),
        "obj_id": obj_id,
        "pcd_depth": np.asarray(pc, np.float32),
        "scale_cad": 0.1,
        "diam_cad": diam,
        "align_pc": align_pc.astype(np.float32),
        "P": pairs,
        "overlap_12": o12,
        "overlap_21": o21,
    }
    if K is not None:
        obj["K"] = np.asarray(K, np.float32)
    if im_hw is not None:
        obj["im_hw"] = np.asarray(im_hw, np.int32)
    return obj
