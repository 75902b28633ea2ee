"""Training CLI (port of pose6d_tpu/cli/train.py; the reference's
scripts/train.py).

    python -m pose6d_tpu_torch.cli.train --config config/lm_synth.yaml \
        [train.batch_size=4 ...] [--device cpu]

Data-parallel over every visible card by default (train.loop.train's
n_devices=None), or as one rank of a process group, one process per
card: start the same command with --coordinator host:port
--num-processes N --process-id i on each process.

Builds the BOP dataset of the config's train_datasets (reading the cache
that generate_cache wrote, or building it on --device) and writes
<logging_dir>/<run>/params_latest.msgpack, which either package reads.
"""
from __future__ import annotations

from ._common import add_multihost_args, base_parser, load


def main(argv=None):
    p = base_parser(__doc__)
    add_multihost_args(p)
    args = p.parse_args(argv)
    cfg = load(args)
    from ..train.loop import train
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
