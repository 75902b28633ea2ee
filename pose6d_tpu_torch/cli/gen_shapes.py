"""Generate a procedural CAD model bank in the BOP models-dir layout
(port of pose6d_tpu/cli/gen_shapes.py).

Writes obj_XXXXXX.ply and models_info.json from data/shapes.py
(superquadrics with smooth deformations), for synth_data to render.

    python -m pose6d_tpu_torch.cli.gen_shapes /tmp/shapes --count 32 --seed 0
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out_dir")
    p.add_argument("--count", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start-id", type=int, default=1)
    p.add_argument("--nu", type=int, default=48)
    p.add_argument("--nv", type=int, default=96)
    args = p.parse_args(argv)

    from ..data.ply import write_ply_mesh
    from ..data.shapes import diameter, random_shape

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    info = {}
    for i in range(args.count):
        obj_id = args.start_id + i
        v, f = random_shape(args.seed * 100003 + obj_id,
                            nu=args.nu, nv=args.nv)
        write_ply_mesh(out / f"obj_{obj_id:06d}.ply", v, f)
        d = diameter(v)
        mins = v.min(axis=0)
        sizes = v.max(axis=0) - mins
        info[str(obj_id)] = {
            "diameter": d,
            "min_x": float(mins[0]), "min_y": float(mins[1]),
            "min_z": float(mins[2]),
            "size_x": float(sizes[0]), "size_y": float(sizes[1]),
            "size_z": float(sizes[2]),
        }
        print(f"obj_{obj_id:06d}: {len(v)} verts, {len(f)} faces, "
              f"diam {d:.1f} mm")
    (out / "models_info.json").write_text(json.dumps(info, indent=1))
    print(f"wrote {args.count} models -> {out}")


if __name__ == "__main__":
    main()
