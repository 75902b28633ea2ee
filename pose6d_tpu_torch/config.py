"""Typed configuration of the entry points (port of
pose6d_tpu/config.py).

One YAML document maps onto the dataclasses below, with the JAX
package's field names and defaults; the model block keeps the
reference's dpfm_orig.yaml key names. Dotted overrides
(``train.batch_size=4``) come from the command line. The YAML is read by
utils/yaml_subset.py, which types scalars as ``yaml.safe_load`` does
(``train.lr=1e-3`` is the string '1e-3' in both packages; ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

from .models.dpfm import DPFMConfig
from .train.loss import DPFMLossConfig
from .utils.yaml_subset import safe_load


@dataclasses.dataclass
class DatasetConfig:
    render_data_name: str = "lm"
    mode: str = "train_pbr"
    num_samples: int = -1
    min_vis: float = 0.3
    obj_take: tuple = ()
    lbo_pc: bool = True
    models_dir: str = "models"
    pc_lbo_backend: str = "host"
    build_gradients: bool = False  # cache tangent-gradient operators
                                   # (with_gradient_features models)


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
    data_root: str = ""
    cache_dir: str = ""
    save_results: Optional[str] = None
    logging_dir: str = "logs"
    comment: str = ""
    # static padding budget (ops.masking defaults)
    pad_v_cad: int = 5120
    pad_v_pc: int = 2048
    target_faces: int = 10000
    model: DPFMConfig = dataclasses.field(default_factory=DPFMConfig)
    loss: DPFMLossConfig = dataclasses.field(default_factory=DPFMLossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    train_datasets: list = dataclasses.field(default_factory=list)
    eval_dataset: DatasetConfig = dataclasses.field(
        default_factory=DatasetConfig)


def _build(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def load_config(path: str | Path, overrides: list[str] = ()) -> Config:
    """The YAML file at `path` with dotted overrides (``a.b=value``, the
    value read as YAML; missing nodes are created) as a Config."""
    raw: dict[str, Any] = safe_load(Path(path).read_text()) or {}
    for ov in overrides:
        key, _, val = ov.partition("=")
        node = raw
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = safe_load(val)
    cfg = Config(
        data_root=raw.get("data_root", ""),
        cache_dir=raw.get("cache_dir", ""),
        save_results=raw.get("save_results"),
        logging_dir=raw.get("logging_dir", "logs"),
        comment=raw.get("comment", ""),
        pad_v_cad=raw.get("pad_v_cad", 5120),
        pad_v_pc=raw.get("pad_v_pc", 2048),
        target_faces=raw.get("target_faces", 10000),
    )
    if "model" in raw:
        # the reference's dpfm_orig.yaml structure (fmap / attention /
        # overlap blocks), or DPFMConfig's own field names
        m = raw["model"]
        cfg.model = (DPFMConfig.from_yaml_dict(m) if "fmap" in m
                     else _build(DPFMConfig, m))
    if "loss" in raw:
        cfg.loss = _build(DPFMLossConfig, raw["loss"])
    if "train" in raw:
        cfg.train = _build(TrainConfig, raw["train"])
    if "eval" in raw:
        cfg.eval = _build(EvalConfig, raw["eval"])
    for block in raw.get("train_datasets", []):
        cfg.train_datasets.append(_build(DatasetConfig, block))
    if "eval_dataset" in raw:
        cfg.eval_dataset = _build(DatasetConfig, raw["eval_dataset"])
    return cfg
