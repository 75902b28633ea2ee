"""Typed configuration of the training and evaluation entry points
(port of the parts of pose6d_tpu/config.py that train() and evaluate()
read).

Config, TrainConfig, EvalConfig and the model / loss blocks, with the
JAX package's field names and defaults. The dataset blocks and
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
class EvalConfig:
    solver: str = "spatial_filtering"  # or "naive"
    pose_solver: str = "ransac"        # ransac | gnc
    ransac_threshold: float = 0.05
    ransac_hypotheses: int = 131072
    gnc_noise_bound: float = 0.05
    icp_max_iter: int = 50
    icp_threshold: float = 0.2
    icp_target: str = "gt_cad"  # reference protocol (test_RANSAC.py:436-439)
    batch_size: int = 8
    # ZoomOut upsampling of the predicted map (solvers/zoomout.py) from
    # n_fmap to zoomout_k cached eigenvectors; 0 = off (reference parity)
    zoomout_k: int = 0
    zoomout_step: int = 4
    zoomout_gate_tau: float = 0.0  # > 0: consistency-gated refit rows
    # rotation TTA (train/eval_loop.py): the model on a fixed bank of
    # rigid rotations of the cloud; 0 / 1 = off. Needs spatial_filtering.
    tta_rotations: int = 0
    # a non-base candidate must beat the base by this fraction
    select_margin: float = 0.15
    # candidate-selection signal: "depth" (a cheap RANSAC pose per
    # candidate scored by depth-render consistency) or "survivors"
    # (spatial-filter survivor counts, also the fallback without
    # intrinsics)
    select_by: str = "depth"
    select_hypotheses: int = 2048  # RANSAC budget per candidate score
    # alternatives compete only where the base map is weak: survivors
    # < select_trigger * valid PC points; 1.0 = always compete
    select_trigger: float = 0.25


@dataclasses.dataclass
class Config:
    save_results: Optional[str] = None
    logging_dir: str = "logs"
    comment: str = ""
    # static padding budget (ops.masking defaults)
    pad_v_cad: int = 5120
    pad_v_pc: int = 2048
    model: DPFMConfig = dataclasses.field(default_factory=DPFMConfig)
    loss: DPFMLossConfig = dataclasses.field(default_factory=DPFMLossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
