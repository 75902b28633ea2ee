"""Cache build CLI (port of pose6d_tpu/cli/generate_cache.py; the
reference's scripts/generate_cache.py): every dataset sample once, so
its preprocessing and spectral operators land in the cache.

Process-parallel: the per-sample operator build is host-bound
numpy / scipy (Delaunay holds the GIL, so threads serialise), so each
spawned worker process builds the dataset from the config and takes
samples one at a time; the host's cores are split between the workers'
BLAS and torch thread pools. Each worker owns its dataset on --device:
with cuda, N workers are N CUDA contexts on one card, time-sliced
(PERF.md measures them), and --workers defaults to min(cores,
CUDA_WORKERS) there. --serial builds in this process.

    python -m pose6d_tpu_torch.cli.generate_cache --config config/lm_synth.yaml
"""
from __future__ import annotations

import os
import sys
import time

from ._common import base_parser, load

# default worker count for --device cuda
CUDA_WORKERS = 4
_DS = None


def _init_worker(cfg, build_eval: bool, device: str):
    from ..runtime import configure
    configure()
    global _DS
    if build_eval:
        from ..train.eval_loop import build_eval_dataset
        _DS = build_eval_dataset(cfg, device=device)
    else:
        from ..train.loop import build_train_dataset
        _DS = build_train_dataset(cfg, device=device)


def _build_one(i):
    try:
        _DS[i]
        return None
    except Exception as e:  # keep building; reported at the end
        return (i, repr(e))


def main(argv=None) -> int:
    p = base_parser(__doc__)
    p.add_argument("--workers", type=int, default=None,
                   help="worker processes (default: the host's cores, at "
                        f"most {CUDA_WORKERS} with --device cuda)")
    p.add_argument("--eval", action="store_true",
                   help="build the eval dataset cache instead of train")
    p.add_argument("--serial", action="store_true",
                   help="build in this process")
    args = p.parse_args(argv)
    cfg = load(args)
    cores = os.cpu_count() or 1
    workers = args.workers or (min(cores, CUDA_WORKERS)
                               if args.device.startswith("cuda") else cores)

    # this process walks the scenes once and writes the scene and mapping
    # lists, which the workers then read
    _init_worker(cfg, args.eval, args.device)
    n = len(_DS)
    workers = 1 if args.serial else max(1, min(workers, n))
    print(f"building cache for {n} samples with {workers} workers on "
          f"{args.device}", flush=True)
    t0 = time.perf_counter()
    if workers == 1:
        errors = [r for r in map(_build_one, range(n)) if r is not None]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        from ..parallel.multihost import worker_threads
        with worker_threads(workers), ProcessPoolExecutor(
                max_workers=workers, mp_context=mp.get_context("spawn"),
                initializer=_init_worker,
                initargs=(cfg, args.eval, args.device)) as ex:
            errors = [r for r in ex.map(_build_one, range(n), chunksize=1)
                      if r is not None]
    seconds = time.perf_counter() - t0
    print(f"done; {len(errors)} failures; {seconds:.1f} s "
          f"({seconds / max(n, 1):.2f} s per sample)")
    for i, e in errors[:20]:
        print(f"  sample {i}: {e}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
