"""Time the port's live online request on the card, for one checkout.

    python3 scripts/torch_request_ms.py --root <checkout> [--reps 7]

Imports pose6d_tpu_torch and chip_smoke from the checkout at --root (this
repository's by default), renders chip_smoke's two online frames (640 x
480, random_shape seeds 38 and 3), builds the default Predictor on the
card with weights/synth_seen.msgpack and prints one JSON line: per frame
the median and all of --reps Predictor.predict walls (host clock around
a synchronised call, after two warm-up requests), and the host cost of
one masked_argmin_cdist wrapper call at ICP's shape (2000 x 5120, C = 3:
the mean over 2000 calls of host time, device synchronised once at the
end). Run it for two checkouts in turns in one call (parent, change,
change, parent) to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_request_ms: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.data.synth import default_intrinsics
    from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
    from pose6d_tpu_torch.ops.kernels import build_all, masked_argmin_cdist
    build_all()
    frames = chip_smoke.render_online_frames()
    model = load_flax_checkpoint(root / "weights" / "synth_seen.msgpack",
                                 DPFMNet()).cuda().eval()
    pred = Predictor(model, {f["obj"]: f["cad_ops"] for f in frames},
                     device="cuda")
    K = default_intrinsics()
    rng = np.random.default_rng(1)
    out = {"root": str(root), "gpu": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "torch": torch.__version__, "ms": {}}
    for f in frames:
        draws = rng.random((256, 512, 3), dtype=np.float32)

        def request():
            pred.predict(f["depth"], K, 1.0, [f["mask"]], [f["obj"]],
                         uniforms=[draws])
            torch.cuda.synchronize()

        walls = []
        for rep in range(args.reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            request()
            if rep >= 2:
                walls.append(1e3 * (time.perf_counter() - t0))
        out["ms"][f["obj"]] = {"median": float(np.median(walls)),
                               "all": walls}
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((1, 2000, 3), device="cuda", generator=g)
    b = torch.randn((1, 5120, 3), device="cuda", generator=g)
    valid = torch.ones((1, 5120), dtype=torch.bool, device="cuda")
    for _ in range(50):
        masked_argmin_cdist(a, b, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        masked_argmin_cdist(a, b, valid)
    host_us = 1e6 * (time.perf_counter() - t0) / 2000
    torch.cuda.synchronize()
    out["argmin_wrapper_host_us"] = host_us
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
