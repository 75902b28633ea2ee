"""Solver registries (port of pose6d_tpu/solvers/registry.py): the
fmap -> point-map solvers by name (the reference's
choose_fmap2pointmap_solver) and the robust pose solvers (its RANSAC /
TEASER script split)."""
from __future__ import annotations

from .fmap2pointmap import naive_fmap2pointmap, spatial_filtering_fmap2pointmap
from .gnc import gnc_tls_pose
from .ransac import ransac_pose

_FMAP2POINTMAP = {
    "naive": naive_fmap2pointmap,
    "spatial_filtering": spatial_filtering_fmap2pointmap,
}

_POSE = {
    "ransac": ransac_pose,
    "gnc": gnc_tls_pose,
}


def choose_fmap2pointmap_solver(name: str = "spatial_filtering"):
    return _FMAP2POINTMAP[name]


def choose_pose_solver(name: str = "ransac"):
    return _POSE[name]
