"""Headless visualization CLI (a copy of pose6d_tpu/cli/visualize.py; the
reference's scripts/visualization.py):
eigenbasis coloring, feature-PCA coloring, correspondence inlier/outlier
dumps — written as colored PLY point clouds (data/ply.py) instead of
interactive polyscope windows.

    python -m pose6d_tpu_torch.cli.visualize basis  <result.npz|cache.npz> <out_dir>
    python -m pose6d_tpu_torch.cli.visualize corr   <result.npz> <out_dir>
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _colormap(values):
    """Map scalars to a diverging blue-white-red colormap (uint8)."""
    v = np.asarray(values, np.float64)
    lim = np.abs(v).max() + 1e-12
    x = np.clip(v / lim, -1, 1)
    r = np.where(x > 0, 255, 255 * (1 + x))
    b = np.where(x < 0, 255, 255 * (1 - x))
    g = 255 * (1 - np.abs(x))
    return np.stack([r, g, b], -1).astype(np.uint8)


def _pca_colors(feats):
    """PCA of features to RGB (reference draw_features/ComparablePCA,
    visualization.py:93-172)."""
    f = feats - feats.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(f, full_matrices=False)
    proj = f @ vt[:3].T
    lo, hi = proj.min(0), proj.max(0)
    return (255 * (proj - lo) / np.maximum(hi - lo, 1e-9)).astype(np.uint8)


def draw_basis(npz_path, out_dir, k_list=(1, 2, 3, 5, 10, 20)):
    from ..data.ply import write_ply_points
    d = dict(np.load(npz_path, allow_pickle=False))
    xyz, evecs = d["xyz"], d["evecs"]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for k in k_list:
        if k < evecs.shape[1]:
            write_ply_points(out / f"basis_{k}.ply", xyz,
                             _colormap(evecs[:, k]))
    print(f"wrote eigenbasis plys to {out}")


def draw_features(npz_path, out_dir):
    from ..data.ply import write_ply_points
    d = dict(np.load(npz_path, allow_pickle=False))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if "overlap12" in d:
        write_ply_points(out / "cad_overlap.ply", d["cad_xyz"],
                         _colormap(d["overlap12"] * 2 - 1))
        write_ply_points(out / "pc_overlap.ply", d["pcd_depth"],
                         _colormap(d["overlap21"] * 2 - 1))
    print(f"wrote feature plys to {out}")


def draw_correspondences(npz_path, out_dir, threshold_frac=0.1):
    """Inlier/outlier colored endpoints + connecting segments sampled as
    points (reference draw_correspondence/sep_in_out_lier,
    visualization.py:175-273)."""
    from ..data.ply import write_ply_points
    d = dict(np.load(npz_path, allow_pickle=False))
    cad, pc, align = d["cad_xyz"], d["pcd_depth"], d["align_pc"]
    P = d["p_pred"].astype(int)
    thresh = threshold_frac * float(d["diam_cad"])
    a = cad[P[:, 0]]
    b = align[P[:, 1]]
    inlier = np.linalg.norm(a - b, axis=1) < thresh
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # line segments rendered as sampled points, green inliers / red outliers
    ts = np.linspace(0, 1, 8)[None, :, None]
    seg = a[:, None, :] * (1 - ts) + b[:, None, :] * ts
    col = np.where(inlier[:, None], 0, 255)
    colors = np.stack([col, 255 - col, np.zeros_like(col)], -1)
    colors = np.repeat(colors[:, None, :], 8, axis=1).reshape(-1, 3)
    write_ply_points(out / "correspondences.ply",
                     seg.reshape(-1, 3), colors.astype(np.uint8))
    write_ply_points(out / "cad.ply", cad)
    write_ply_points(out / "pc_aligned.ply", align)
    print(f"wrote {inlier.sum()}/{len(P)} inlier correspondences to {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("what", choices=["basis", "features", "corr"])
    p.add_argument("npz")
    p.add_argument("out_dir")
    args = p.parse_args(argv)
    if args.what == "basis":
        draw_basis(args.npz, args.out_dir)
    elif args.what == "features":
        draw_features(args.npz, args.out_dir)
    else:
        draw_correspondences(args.npz, args.out_dir)


if __name__ == "__main__":
    main()
