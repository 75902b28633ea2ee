"""The pose pool of inputs/frames.py with each frame's depth image kept.

The same shapes, poses, renders, clouds and operators from the same
seeds (shape_task draws in frames.shape_task's order), and besides them
what the flip stage reads: each frame's depth in cm (the uint16 render
x 0.1, float32, 0 where empty), its mask (depth > 0) and the camera K
(render.default_intrinsics, the renders' intrinsics). The shape's CAD
vertices in cm, from which a flip bank is built, are its cad_ops["xyz"].
"""
from __future__ import annotations

import os
import warnings
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from . import cloud, lbo, render, shapes
from .frames import _THREAD_VARS, _pose

IMAGE = (render.H, render.W)      # the renders' height and width


def shape_task(task_seed: int, n_poses: int, spec: dict) -> dict:
    """frames.shape_task's shape and frames, each frame with its depth
    image: "depth_cm" (H, W) float32 and "mask" (H, W) bool."""
    verts, faces = shapes.random_shape(task_seed, nu=spec["nu"],
                                       nv=spec["nv"])
    rng = np.random.default_rng([task_seed, 1])
    cad_ops = lbo.point_cloud_operators(verts * 0.1, int(rng.integers(2**31)),
                                        k_eig=spec["k_eig"])
    diam = float(np.linalg.norm(cad_ops["xyz"].max(0)
                                - cad_ops["xyz"].min(0)))
    frames = []
    for p in range(n_poses):
        R, t = _pose(rng)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            depth = render.rasterize_depth(verts, faces, R, t)
        degraded = p % 2 == 1
        if degraded:
            depth = render.degrade_depth(depth, rng, noise_mm=1.0,
                                         hole_frac=0.02)
        depth = np.clip(depth, 0, 65535).astype(np.uint16)
        pts = cloud.backproject(depth)
        pts = pts[cloud.farthest_point_sample(pts, spec["max_pc"])]
        pc_ops = lbo.point_cloud_operators(pts, int(rng.integers(2**31)),
                                           k_eig=spec["k_eig"])
        frames.append({"pc_ops": pc_ops, "R": R, "t": t * 0.1,
                       "degraded": degraded,
                       "depth_cm": depth.astype(np.float32) * np.float32(0.1),
                       "mask": depth > 0})
    return {"cad_ops": cad_ops, "diam": diam, "frames": frames}


def intrinsics() -> np.ndarray:
    """The renders' camera matrix (3, 3), float32."""
    return render.default_intrinsics().astype(np.float32)


class PoolJob:
    """frames.PoolJob running this module's shape_task."""

    def __init__(self, seed, n_shapes, n_poses, spec, workers):
        task_seeds = np.random.default_rng(
            np.random.SeedSequence(seed)).integers(0, 2**62, n_shapes)
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            self.pool = ProcessPoolExecutor(
                max_workers=max(1, min(workers, n_shapes)),
                mp_context=get_context("spawn"))
            self.futures = [self.pool.submit(shape_task, int(s), n_poses,
                                             spec) for s in task_seeds]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def result(self) -> list:
        try:
            return [f.result() for f in self.futures]
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)


def start_pool(seed: int, n_shapes: int, n_poses: int, *, max_pc: int = 2000,
               k_eig: int = 64, nu: int = 48, nv: int = 96,
               workers: int = 8) -> PoolJob:
    """frames.start_pool with the depth images kept (shape_task)."""
    spec = {"max_pc": max_pc, "k_eig": k_eig, "nu": nu, "nv": nv}
    return PoolJob(seed, n_shapes, n_poses, spec, workers)
