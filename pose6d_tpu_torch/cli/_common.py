"""Shared argument parsing and config loading of the port's CLIs (port
of pose6d_tpu/cli/_common.py)."""
from __future__ import annotations

import argparse

def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("overrides", nargs="*",
                   help="dotted config overrides read as YAML, e.g. "
                        "train.batch_size=4 (YAML 1.1 reads 1e-3 as a "
                        "string: write 1.0e-3)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def add_multihost_args(p: argparse.ArgumentParser) -> None:
    """The multi-process flags: one process per card, joined over
    torch.distributed (train: data-parallel; eval: frame-sharded)."""
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0; runs this process as one "
                        "rank of a process group (nccl with --device cuda, "
                        "gloo with --device cpu)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the group (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --coordinator)")


def load(args):
    """The Config of args.config with args.overrides, after joining the
    process group that --coordinator names (before anything else)."""
    if getattr(args, "coordinator", None):
        from ..parallel import init_multihost
        init_multihost(args.coordinator, args.num_processes,
                       args.process_id,
                       backend=("nccl" if args.device.startswith("cuda")
                                else "gloo"))
    from ..config import load_config
    from ..runtime import configure
    configure()
    return load_config(args.config, args.overrides)
