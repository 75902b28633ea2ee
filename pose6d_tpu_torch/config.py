"""Typed configuration of the training entry point (port of the parts
of pose6d_tpu/config.py that train() reads).

Config, TrainConfig and the model / loss blocks, with the JAX package's
field names and defaults. The dataset and evaluation blocks and
load_config (YAML, dotted overrides) wait for the CLI slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .models.dpfm import DPFMConfig
from .train.loss import DPFMLossConfig


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 8
    lr: float = 5e-4                  # RMSprop lr
    decay_iter: int = 500             # epochs between decays
    decay_factor: float = 0.1
    epochs: int = 5000
    grad_clip: float = 5.0
    checkpoint_interval: int = 1      # epochs
    checkpoint_every_steps: int = 0   # extra step cadence (0 = off)
    checkpoint_keep: int = 5          # retained ckpt_*.pt files
    log_interval: int = 1             # steps
    num_threads: int = 4
    seed: int = 0
    pretrained: Optional[str] = None  # a flax msgpack params file
    log_ir: bool = False              # train inlier-ratio probe
    # train-time rigid augmentation of the partial cloud (degrees /
    # pipeline cm; 0 = off), see train/augment.py
    augment_rotation_deg: float = 0.0
    augment_translation: float = 0.0
    resume_dir: Optional[str] = None  # existing run dir to resume into
    max_steps: Optional[int] = None   # stop at this global step


@dataclasses.dataclass
class Config:
    logging_dir: str = "logs"
    comment: str = ""
    # static padding budget (ops.masking defaults)
    pad_v_cad: int = 5120
    pad_v_pc: int = 2048
    model: DPFMConfig = dataclasses.field(default_factory=DPFMConfig)
    loss: DPFMLossConfig = dataclasses.field(default_factory=DPFMLossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
