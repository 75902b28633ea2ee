"""Generate a synthetic-GT BOP dataset from CAD models (port of
pose6d_tpu/cli/synth_data.py).

Rasterizes CAD meshes at random poses into BOP-format scenes with exact
ground truth, one dataset <name>_obj<id> per object.

    python -m pose6d_tpu_torch.cli.synth_data <out_root> --name synth \
        --models /tmp/shapes --objects 1 2 --frames 16 --z-range 900 1200
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out_root")
    p.add_argument("--name", default="synth")
    p.add_argument("--models", required=True,
                   help="dir with obj_XXXXXX.ply + models_info.json")
    p.add_argument("--objects", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--z-range", type=float, nargs=2, default=(900, 1200))
    p.add_argument("--rot-sigma", type=float, default=0.9)
    p.add_argument("--target-faces", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--occlude-prob", type=float, default=0.0,
                   help="per-frame probability of a box occluder "
                        "(visib_fract computed exactly from z-buffers)")
    p.add_argument("--depth-noise-mm", type=float, default=0.0,
                   help="Gaussian depth noise sigma in mm (sensor model)")
    p.add_argument("--hole-frac", type=float, default=0.0,
                   help="fraction of valid depth pixels zeroed as "
                        "dropout blobs")
    args = p.parse_args(argv)

    from scipy.spatial.transform import Rotation

    from ..data.decimate import decimate_mesh
    from ..data.ply import read_ply
    from ..data.synth import write_bop_scene

    models_dir = Path(args.models)
    info = json.loads((models_dir / "models_info.json").read_text())
    rng = np.random.default_rng(args.seed)
    for obj_id in args.objects:
        mesh = read_ply(models_dir / f"obj_{obj_id:06d}.ply")
        v, f = decimate_mesh(mesh["verts"], mesh["faces"], args.target_faces)
        diam = info[str(obj_id)]["diameter"]
        poses = []
        for _ in range(args.frames):
            R = Rotation.from_rotvec(
                rng.normal(size=3) * args.rot_sigma).as_matrix()
            t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                          rng.uniform(*args.z_range)])
            poses.append((R, t))
        write_bop_scene(Path(args.out_root), f"{args.name}_obj{obj_id}",
                        {"verts": v, "faces": f}, obj_id=obj_id,
                        poses=poses, diameter_mm=diam,
                        occlude_prob=args.occlude_prob,
                        depth_noise_mm=args.depth_noise_mm,
                        hole_frac=args.hole_frac,
                        seed=args.seed + obj_id)
        print(f"wrote {args.frames} frames for obj {obj_id}")


if __name__ == "__main__":
    main()
