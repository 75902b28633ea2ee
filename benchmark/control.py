"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs):

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 3] [--out build/control.jsonl]

For every seed: the cell's set-up at its own size, a short window at
its own load (`--seconds`), and the numbers `correct` compares for the
program (the lower readings). For the first --control-seeds seeds also
the same numbers for the control, the reference in the precision just
below the configuration's float32 (TF32 products, reference/precision.py)
put in the program's place, and for a fault planted in the program's
answers: ICP skipped on a quarter of the batch's slots (its RANSAC pose
returned). One JSON line per reading, with every judged frame's pose
gaps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from importlib import import_module
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def icp_skipped(got: list, share: float = 0.25) -> list:
    """The program's records with ICP's answer replaced by its RANSAC
    pose on the first `share` of every batch's slots."""
    out = []
    for g in got:
        n = int(g["out"]["R"].shape[0] * share)
        o = dict(g["out"], R=g["out"]["R"].clone(), t=g["out"]["t"].clone())
        o["R"][:n] = g["stage"]["ransac"]["R"][:n]
        o["t"][:n] = g["stage"]["ransac"]["t"][:n]
        out.append(dict(g, out=o))
    return out


def readings(cell: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", overrides: dict | None = None,
             root: Path = ROOT) -> list:
    sys.path.insert(0, str(root))
    from benchmark import harness
    from benchmark.reference.precision import Prec
    spec = harness.load_cell(cell, root)
    traffic = dict(spec["traffic"], **(overrides or {}))
    run = harness.Run(cell=cell, config=spec["config"], traffic=traffic,
                      seed=seed, trace=False)
    drv = import_module(f"benchmark.drivers.{traffic['entry']}")
    st = drv.setup({"run": run, "device": device, "root": root})
    drv.window(st, seconds, False)
    got, _ = drv.records(st)
    kinds = [("program", got, None)]
    if control:
        kinds += [("control_tf32", got, Prec("tf32")),
                  ("fault_icp_quarter", icp_skipped(got), None)]
    out = []
    for name, records, prec in kinds:
        t0 = time.perf_counter()
        r = drv.readings(st, records, prec)
        out.append({"seed": seed, "who": name,
                    "numbers": {c["name"]: c["value"]
                                for c in drv.summary(r)},
                    "reference_s": time.perf_counter() - t0,
                    "window_items": sum(run.done),
                    "frames": r["per_frame"]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    for k, seed in enumerate(args.seeds):
        for line in readings(args.workload, seed, args.seconds,
                             k < args.control_seeds):
            text = json.dumps(line)
            print(json.dumps(dict(line, frames=len(line["frames"]))),
                  flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
