"""The benchmark's input pool, made from the run's seed on the host.

Each shape is a procedural mesh (shapes.random_shape, 4610 vertices at
the default grid) whose CAD operators are those of its vertices in cm.
Each of its frames is a 640 x 480 depth render at a pose drawn as
chip_smoke.py draws them (rotation vector ~ N(0, 0.9^2), t in [-60, 60]
x [-40, 40] x [900, 1200] mm), every other frame degraded by 1 mm noise
and 2 % holes, backprojected, farthest-point sampled and given its own
operators.

One task per shape runs in a pool of spawned processes, each with one
BLAS thread; the tasks depend on their seeds alone, so the pool's size
changes nothing in the result.
"""
from __future__ import annotations

import os
import warnings
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from . import cloud, lbo, render, shapes

_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _pose(rng):
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.9).as_matrix()
    t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                  rng.uniform(900, 1200)])
    return R, t


def shape_task(task_seed: int, n_poses: int, spec: dict) -> dict:
    """One shape and its frames, from task_seed alone."""
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
                       "degraded": degraded})
    return {"cad_ops": cad_ops, "diam": diam, "frames": frames}


class PoolJob:
    """The pool's tasks running in spawned processes; result() waits for
    them and stops the processes."""

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
    """Start making n_shapes shapes of n_poses frames each from `seed`
    (any integer up to 2^63); .result() gives the list of shape_task
    results. The spawned workers start with one BLAS thread each; the
    caller's environment is left as it was."""
    spec = {"max_pc": max_pc, "k_eig": k_eig, "nu": nu, "nv": nv}
    return PoolJob(seed, n_shapes, n_poses, spec, workers)
