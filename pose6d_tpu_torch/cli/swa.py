"""Checkpoint averaging (SWA): the uniform average of the model state over
a step window of a training run's kept checkpoint curve (port of
pose6d_tpu/cli/swa.py).

    python -m pose6d_tpu_torch.cli.swa --run <run_dir> \
        --min-step 2000 --max-step 8000 --out swa_params.msgpack [--device cpu]

Reads the ckpt/ckpt_*.pt files that the port's train() keeps (the JAX
command reads its ckpt_*.msgpack train states). Each leaf is summed in
float64 in checkpoint order, divided by the count and cast back to its
own type, as the JAX command does, on the device (float64 sums and the
division round as IEEE prescribes, so card and CPU give the same bits).
Writes a flax msgpack params file
(models/weights.save_flax_params), which cli/eval.py --weights of either
package loads. Pairs with cli/probe_ckpts: probe the raw curve, then
probe SWA windows as further candidates.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def checkpoint_step(path) -> int:
    return int(Path(path).stem.split("_")[1])


def select_paths(run, min_step=0, max_step=10**9, every=1):
    """The run's ckpt_*.pt files with min_step <= step <= max_step, in
    step order, every `every`-th; raises SystemExit when there is none."""
    ckpts = sorted(Path(run).glob("ckpt/ckpt_*.pt"))
    out = [c for c in ckpts
           if min_step <= checkpoint_step(c) <= max_step][::every]
    if not out:
        raise SystemExit(f"no checkpoints in [{min_step}, {max_step}] "
                         f"under {run}/ckpt")
    return out


def load_model_state(path, device="cpu") -> dict:
    """The model's state_dict of one checkpoint, on `device`."""
    import torch
    return torch.load(path, map_location=device, weights_only=True)["model"]


def average_checkpoints(paths, device="cpu") -> dict:
    """Uniform average of the model states of `paths` (a state_dict on
    `device`); raises ValueError when two checkpoints hold different
    trees."""
    acc, dtypes = None, None
    for p in paths:
        state = load_model_state(p, device)
        if acc is None:
            acc = {k: v.double().clone() for k, v in state.items()}
            dtypes = {k: v.dtype for k, v in state.items()}
            continue
        if state.keys() != acc.keys() or any(
                state[k].shape != acc[k].shape for k in acc):
            raise ValueError(f"checkpoint {p} has a different parameter "
                             "tree; cannot average")
        for k in acc:
            acc[k] += state[k].double()
    n = len(paths)
    return {k: (v / n).to(dtypes[k]) for k, v in acc.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", required=True,
                   help="train run dir containing ckpt/ckpt_*.pt")
    p.add_argument("--min-step", type=int, default=0)
    p.add_argument("--max-step", type=int, default=10**9)
    p.add_argument("--every", type=int, default=1,
                   help="average every Nth checkpoint in the window")
    p.add_argument("--out", required=True, help="output params msgpack")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..models.weights import save_flax_params
    from ..runtime import resolve_device
    device = resolve_device(args.device)
    paths = select_paths(args.run, args.min_step, args.max_step, args.every)
    steps = [checkpoint_step(c) for c in paths]
    avg = average_checkpoints(paths, device)
    save_flax_params(args.out, avg)
    print(f"averaged {len(paths)} checkpoints "
          f"(steps {steps[0]}..{steps[-1]}) -> {args.out}")
    return avg


if __name__ == "__main__":
    main()
