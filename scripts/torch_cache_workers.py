"""How the port's cache build scales with its worker processes on one
card: one corpus of random_shape scenes (gen_shapes -> synth_data, as
the README's workflow writes it), built by
``python -m pose6d_tpu_torch.cli.generate_cache --device cuda`` with
each worker count in turn (1 is --serial), each into a fresh cache
directory. Every worker is its own CUDA context on the card.

    python scripts/torch_cache_workers.py [--objects 4] [--frames 8] \
        [--workers 1 2 4 8]

Prints one JSON line per build (wall seconds, seconds per sample, the
card's used memory before and at its peak, nvidia-smi sampled every
0.5 s), then the card's name and power limit. Writes under
build/cache_workers/.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "cache_workers"
CONFIG = ROOT / "config" / "lm_synth.yaml"


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def memory_mib() -> int:
    return int(smi("memory.used").split()[0])


def cli(name: str, *args, poll: bool = False) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    before = peak = memory_mib() if poll else None
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m",
                             f"pose6d_tpu_torch.cli.{name}",
                             *map(str, args)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    while proc.poll() is None:
        if poll:
            peak = max(peak, memory_mib())
        time.sleep(0.5)
    out = proc.stdout.read()
    if proc.returncode != 0:
        raise SystemExit(f"cli.{name} failed ({proc.returncode}):\n{out}")
    return {"s": time.perf_counter() - t0, "out": out,
            "memory_before_mib": before, "memory_peak_mib": peak}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--objects", type=int, default=4)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    args = p.parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    ids = [str(i) for i in range(1, args.objects + 1)]
    cli("gen_shapes", OUT / "models", "--count", args.objects, "--seed", 7)
    cli("synth_data", OUT / "data", "--models", OUT / "models", "--objects",
        *ids, "--frames", args.frames, "--seed", 7)
    datasets = "[" + ", ".join(f"{{render_data_name: synth_obj{i}}}"
                               for i in ids) + "]"
    for n in args.workers:
        cache = OUT / f"cache_{n}"
        mode = ["--serial"] if n == 1 else ["--workers", n]
        r = cli("generate_cache", "--config", CONFIG, "--device", "cuda",
                *mode, f"data_root={OUT / 'data'}", f"cache_dir={cache}",
                f"train_datasets={datasets}", poll=True)
        samples = args.objects * args.frames
        print(json.dumps({
            "workers": n, "samples": samples, "wall_s": r["s"],
            "s_per_sample": r["s"] / samples,
            "memory_before_mib": r["memory_before_mib"],
            "memory_peak_mib": r["memory_peak_mib"],
            "cli_line": [ln for ln in r["out"].splitlines()
                         if ln.startswith("done")]}), flush=True)
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
