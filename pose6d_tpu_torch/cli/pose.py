"""Pose estimation CLI (port of pose6d_tpu/cli/pose.py; the reference's
scripts/test_RANSAC.py / test_teaser.py):

    python -m pose6d_tpu_torch.cli.pose ransac <results_dir> <out_dir>
    python -m pose6d_tpu_torch.cli.pose gnc    <results_dir> <out_dir>

Runs on the GPU unless --device cpu is given.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("solver", choices=["ransac", "gnc"])
    p.add_argument("results_dir")
    p.add_argument("out_dir")
    p.add_argument("--icp-target", choices=["gt_cad", "pc"],
                   default="gt_cad")
    p.add_argument("--no-ply", action="store_true")
    p.add_argument("--ransac-threshold", type=float, default=0.05)
    p.add_argument("--gnc-noise-bound", type=float, default=0.05)
    p.add_argument("--gnc-core", action="store_true",
                   help="TEASER-parity mutual-consistency core peel "
                        "before GNC (solvers/gnc.consistency_core), for "
                        "correspondences that did not pass the spatial "
                        "filter")
    p.add_argument("--disambiguate", action="store_true",
                   help="depth-render flip disambiguation between the "
                        "solver and ICP (needs K in the result npzs)")
    p.add_argument("--suffix", default="",
                   help="append to the results_poses_* dir name")
    p.add_argument("--batch", type=int, default=8,
                   help="instances per device chunk")
    p.add_argument("--hypotheses", type=int, default=131072,
                   help="RANSAC trial budget (reference: 80k draws + 4M "
                        "checks)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from ..train.pose_stage import run_pose_stage
    run_pose_stage(args.results_dir, args.out_dir, solver=args.solver,
                   ransac_threshold=args.ransac_threshold,
                   ransac_hypotheses=args.hypotheses,
                   gnc_noise_bound=args.gnc_noise_bound,
                   icp_target=args.icp_target, write_ply=not args.no_ply,
                   disambiguate=args.disambiguate, gnc_core=args.gnc_core,
                   name_suffix=args.suffix, batch=args.batch,
                   device=args.device)


if __name__ == "__main__":
    main()
