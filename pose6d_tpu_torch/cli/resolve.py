"""Post-hoc correspondence re-solving (port of pose6d_tpu/cli/resolve.py;
the reference's scripts/eval_2.py): reload saved eval results, re-run a
fmap2pointmap solver (the other solver, or another k and pruning
schedule), and write p_pred and ir back into each file.

    python -m pose6d_tpu_torch.cli.resolve <results_dir> \
        [--solver naive] [--topk 8] [--taus 0.3 0.15 0.055 0.065] \
        [--device cpu]

Reads the result_*.npz files that either package's eval writes. Each
file runs as one frame, padded to a multiple of 512 points as the JAX
command pads it.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

PAD_MULTIPLE = 512


def _padded(n: int) -> int:
    return PAD_MULTIPLE * ((n + PAD_MULTIPLE - 1) // PAD_MULTIPLE)


def resolve_file(r: dict, solver: str = "spatial_filtering", topk: int = 5,
                 taus=None, device="cuda"):
    """One result file's arrays -> (pairs (2, P) int32, valid (P,) bool,
    ir) from the solver on `device`."""
    import torch

    from ..ops.masking import pad_to
    from ..solvers import (naive_fmap2pointmap,
                           spatial_filtering_fmap2pointmap)
    from ..train.metrics import inlier_ratio

    nc, npc = len(r["cad_xyz"]), len(r["pcd_depth"])
    vc, vp = _padded(nc), _padded(npc)

    def dev(x, n=None):
        x = np.asarray(x) if n is None else pad_to(x, n)
        return torch.as_tensor(np.ascontiguousarray(x), device=device)[None]

    ex, ey = dev(r["evecs_cad"], vc), dev(r["evecs_pc"], vp)
    xv = dev(np.arange(vc) < nc)
    yv = dev(np.arange(vp) < npc)
    C = dev(r["C_pred"])
    cad = dev(r["cad_xyz"], vc)
    diam = float(r["diam_cad"])
    diam_t = torch.tensor([diam], dtype=torch.float32, device=device)
    with torch.inference_mode():
        if solver == "naive":
            pairs, valid = naive_fmap2pointmap(C, ex, ey, xv, yv)
        else:
            kw = {"k": topk}
            if taus:
                kw["taus"] = tuple(taus)
            pairs, valid = spatial_filtering_fmap2pointmap(
                C, ex, ey, cad, dev(r["pcd_depth"], vp), xv, yv, diam_t, **kw)
        # the threshold rounded once from float64, as JAX takes a Python
        # float
        thr = torch.tensor([0.1 * diam], dtype=torch.float32, device=device)
        ir = float(inlier_ratio(pairs, valid, cad, dev(r["align_pc"], vp),
                                thr)[0])
    return pairs[0].cpu().numpy(), valid[0].cpu().numpy(), ir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_dir")
    p.add_argument("--solver", choices=["naive", "spatial_filtering"],
                   default="spatial_filtering")
    p.add_argument("--topk", type=int, default=5,
                   help="spectral candidates per PC point")
    p.add_argument("--taus", type=float, nargs="+", default=None,
                   help="consistency schedule as diam fractions; last "
                        "two = (tight, loose-fallback) final round")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from ..runtime import resolve_device
    device = resolve_device(args.device)

    irs = []
    for f in sorted(Path(args.results_dir).glob("result_*.npz")):
        with np.load(f, allow_pickle=False) as z:
            r = {k: z[k] for k in z.files}
        if "evecs_cad" not in r:
            print(f"{f.name}: no saved bases, skipping")
            continue
        pairs, pv, ir = resolve_file(r, args.solver, args.topk, args.taus,
                                     device)
        r["p_pred"] = pairs[:, pv].T
        r["ir"] = ir
        np.savez(f, **r)
        irs.append(ir)
        print(f"{f.name}: ir={ir:.4f} pairs={pv.sum()}")
    if irs:
        print(f"mean IR: {np.mean(irs):.4f}")
    return irs


if __name__ == "__main__":
    main()
