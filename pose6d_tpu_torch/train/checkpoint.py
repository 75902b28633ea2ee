"""Checkpoints (port of pose6d_tpu/train/checkpoint.py).

Full resume state in the PyTorch idiom: torch.save of the model's and
the optimizer's state_dicts and the step, as ckpt_{step:08d}.pt beside
latest.json, keeping the last K. Weights-only export is a flax msgpack
params file (models/weights.py), which the JAX package reads.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from ..models.weights import save_flax_params


def save_checkpoint(ckpt_dir, model, optimizer, step: int, keep: int = 5):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"ckpt_{step:08d}.pt"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": step}, path)
    (ckpt_dir / "latest.json").write_text(json.dumps({"step": step}))
    for old in sorted(ckpt_dir.glob("ckpt_*.pt"))[:-keep]:
        old.unlink()
    return path


def latest_checkpoint(ckpt_dir):
    meta = Path(ckpt_dir) / "latest.json"
    if not meta.exists():
        return None
    step = json.loads(meta.read_text())["step"]
    path = Path(ckpt_dir) / f"ckpt_{step:08d}.pt"
    return path if path.exists() else None


def restore_checkpoint(path, model, optimizer) -> int:
    """Load model and optimizer state in place; returns the step."""
    state = torch.load(path, map_location=next(model.parameters()).device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def save_params(path, model) -> None:
    """Weights-only export: a flax {"params": ...} msgpack file."""
    save_flax_params(path, model)
