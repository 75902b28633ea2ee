"""Shared argument parsing and config loading of the port's CLIs (port
of pose6d_tpu/cli/_common.py)."""
from __future__ import annotations

import argparse

_NO_MULTIHOST = ("multi-process runs (--coordinator, --num-processes, "
                 "--process-id) are not ported yet (ROADMAP.md, modules "
                 "still to port, item 11): run one process on one card")


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
    """The JAX CLI's multi-host flags: accepted, and refused by load()."""
    p.add_argument("--coordinator", default=None,
                   help="not ported: raises NotImplementedError")
    p.add_argument("--num-processes", type=int, default=None,
                   help="not ported: raises NotImplementedError")
    p.add_argument("--process-id", type=int, default=None,
                   help="not ported: raises NotImplementedError")


def load(args):
    """The Config of args.config with args.overrides; raises on a
    multi-host flag."""
    if any(getattr(args, k, None) is not None
           for k in ("coordinator", "num_processes", "process_id")):
        raise NotImplementedError(_NO_MULTIHOST)
    from ..config import load_config
    from ..runtime import configure
    configure()
    return load_config(args.config, args.overrides)
