"""The training loop on one device (port of pose6d_tpu/train/loop.py).

Epoch loop over a HostLoader with the step-decay lr, gradient clip,
per-step and per-epoch scalars (metrics.jsonl), the optional train-IR
probe, checkpoints every checkpoint_interval epochs and every
checkpoint_every_steps steps (full resume state, .pt), the weights-only
params_latest.msgpack export (flax msgpack), an optional pretrained
init from a flax msgpack params file or the reference's weights.pt
(load_pretrained_params: an xyz-trained checkpoint warm-starts a model
with appended input channels, any other shape mismatch raises), and
resume from the run directory's
latest checkpoint. A fresh model is drawn as flax draws one
(models.weights.init_like_flax).

The random draws of every step (augmentation, NCE subsample) come from
one torch.Generator on the training device, seeded with cfg.train.seed;
a resumed run reseeds it from (seed, restored step) and advances the
loader's epoch, so a chain of capped runs samples like one run (the
JAX package's resume_offsets; the semantics, not the bits).

Without a dataset, train() builds the BOP dataset of cfg.train_datasets
(build_train_dataset; its preprocessing runs on the training device).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.dataset import dataset_from_config
from ..data.pipeline import HostLoader, to_device
from ..models import DPFMNet, init_like_flax
from ..models.port_weights import (extend_first_lin_input,
                                   load_reference_checkpoint)
from ..models.weights import (flax_from_state_dict, read_flax_msgpack,
                              state_dict_from_flax)
from ..runtime import resolve_device
from ..solvers import naive_fmap2pointmap
from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint, save_params)
from .logging import MetricsLogger
from .metrics import inlier_ratio
from .train_step import TrainStep

_NO_MESH = ("data-parallel training over several GPUs is not ported yet "
            "(ROADMAP.md, modules still to port, item 11)")


class ConcatDataset:
    """Several datasets as one (the reference's utils/utils.py)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


def build_train_dataset(cfg, device="cuda"):
    """The BOP dataset of cfg.train_datasets (one block: that dataset;
    several: their concatenation), preprocessing on `device`."""
    if not cfg.train_datasets:
        raise ValueError("cfg.train_datasets is empty: no dataset to train "
                         "on")
    ds = [dataset_from_config(cfg, d, device) for d in cfg.train_datasets]
    return ds[0] if len(ds) == 1 else ConcatDataset(ds)


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def _prefix_input_rows(model_cfg) -> set:
    """Row counts of every proper prefix of the model's input channels
    (fixed order xyz -> hks -> wks): a narrower checkpoint widens
    function-preservingly only when its first_lin rows equal one of
    them, i.e. the new channels are appended at the end."""
    f = model_cfg.input_features
    sizes = ([3] * ("xyz" in f) + [model_cfg.n_hks] * ("hks" in f)
             + [model_cfg.n_wks] * ("wks" in f))
    return {sum(sizes[:i]) for i in range(1, len(sizes))}


def load_pretrained_params(path: str, template: dict,
                           model_cfg=None) -> dict:
    """A flax msgpack params file, or the reference's torch checkpoint
    (a .pt path, models/port_weights.load_reference_checkpoint), as a
    {"params": tree} for a model whose own tree is `template`
    ({"params": flax_from_state_dict(...)}).
    When the file's first_lin has fewer input rows than the template's,
    the same width, and a row count that is a prefix of model_cfg's
    channel layout, its rows are zero-extended (extend_first_lin_input);
    a narrower checkpoint that is not a prefix raises. Other mismatches
    raise when the tree is loaded strictly."""
    if str(path).endswith(".pt"):
        loaded = load_reference_checkpoint(path)
    else:
        loaded = read_flax_msgpack(path)
    try:
        tk = template["params"]["feature_extractor"]["first_lin"]["kernel"]
        lk = loaded["params"]["feature_extractor"]["first_lin"]["kernel"]
    except (KeyError, TypeError):
        return loaded
    if lk.shape[0] < tk.shape[0] and lk.shape[1] == tk.shape[1]:
        allowed = (_prefix_input_rows(model_cfg) if model_cfg is not None
                   else {lk.shape[0]})
        if lk.shape[0] not in allowed:
            raise ValueError(
                f"pretrained checkpoint has {lk.shape[0]} input rows; "
                f"model expects {tk.shape[0]} and {lk.shape[0]} is not a "
                f"prefix of its channel layout "
                f"({getattr(model_cfg, 'input_features', None)!r}): "
                "refusing to widen")
        loaded = extend_first_lin_input(loaded, tk.shape[0] - lk.shape[0])
        print(f"pretrained: widened first_lin input {lk.shape[0]} -> "
              f"{tk.shape[0]} rows (appended channels zero-initialized)")
    return loaded


def resume_offsets(restored_step: int, steps_per_epoch: int, seed: int,
                   device) -> tuple[int, torch.Generator]:
    """Loader epoch and draw generator for a run resumed at
    `restored_step`: the epoch it had reached, and a generator keyed by
    (seed, restored_step)."""
    key = int(np.random.SeedSequence((seed, restored_step)).generate_state(
        1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(key)
    return restored_step // steps_per_epoch, gen


def train(cfg, dataset=None, max_steps: int | None = None,
          sample_kw: dict | None = None, device="cuda",
          n_devices: int = 1) -> TrainState:
    """Run training per config on one device; returns the final
    TrainState. dataset: a sequence of (cad_ops, pc_ops, obj) triples,
    or None for build_train_dataset(cfg) on `device`. sample_kw forwards
    to data.pipeline.make_sample (e.g. smaller v_cad / v_pc padding)."""
    if n_devices != 1:
        raise NotImplementedError(_NO_MESH)
    dev = resolve_device(device)
    if dataset is None:
        dataset = build_train_dataset(cfg, device=dev)
    tcfg = cfg.train
    if max_steps is None:
        max_steps = tcfg.max_steps
    kw = {"v_cad": cfg.pad_v_cad, "v_pc": cfg.pad_v_pc}
    kw.update(sample_kw or {})
    loader = HostLoader(dataset, tcfg.batch_size, shuffle=True,
                        seed=tcfg.seed, num_threads=tcfg.num_threads, **kw)
    steps_per_epoch = max(len(loader), 1)

    model = init_like_flax(DPFMNet(cfg.model),
                           torch.Generator().manual_seed(tcfg.seed))
    if tcfg.pretrained and str(tcfg.pretrained).lower() != "none":
        template = {"params": flax_from_state_dict(model.state_dict())}
        loaded = load_pretrained_params(tcfg.pretrained, template, cfg.model)
        model.load_state_dict(state_dict_from_flax(loaded["params"]),
                              strict=True)
    model.to(dev)
    step_fn = TrainStep(
        model, cfg.loss, lr=tcfg.lr, decay_factor=tcfg.decay_factor,
        decay_every_steps=tcfg.decay_iter * steps_per_epoch,
        clip_norm=tcfg.grad_clip,
        augment_angle=float(np.deg2rad(tcfg.augment_rotation_deg)),
        augment_trans=tcfg.augment_translation)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)

    logger = MetricsLogger(cfg.logging_dir, cfg.comment,
                           run_dir=tcfg.resume_dir)
    ckpt_dir = logger.dir / "ckpt"
    global_step = 0
    latest = latest_checkpoint(ckpt_dir)
    if latest is not None:
        global_step = restore_checkpoint(latest, model, step_fn.optimizer)
        loader.epoch, gen = resume_offsets(global_step, steps_per_epoch,
                                           tcfg.seed, dev)

    nf = cfg.model.n_fmap
    for epoch in range(1, tcfg.epochs + 1):
        epoch_logs = []
        for batch in loader:
            batch = to_device(batch, dev)
            logs = step_fn(batch, global_step, step_fn.draw(batch, gen))
            C = logs.pop("_C")
            # one device -> host copy for all scalars
            logs = dict(zip(logs, torch.stack(list(logs.values()))
                            .cpu().tolist()))
            if tcfg.log_ir and (global_step + 1) % tcfg.log_interval == 0:
                with torch.no_grad():
                    pairs, pvalid = naive_fmap2pointmap(
                        C, batch["cad"]["evecs"][..., :nf],
                        batch["pc"]["evecs"][..., :nf],
                        batch["cad"]["valid"], batch["pc"]["valid"])
                    ir = inlier_ratio(pairs, pvalid, batch["cad"]["xyz"],
                                      batch["align_pc"],
                                      0.1 * batch["diam_cad"])
                logs["IR"] = float(ir.mean())
            logger.log(logs, step=global_step)
            epoch_logs.append(logs)
            global_step += 1
            if global_step % tcfg.log_interval == 0:
                print(f"epoch {epoch} step {global_step} "
                      f"loss {logs['loss']:.4f}")
            if (tcfg.checkpoint_every_steps
                    and global_step % tcfg.checkpoint_every_steps == 0):
                save_checkpoint(ckpt_dir, model, step_fn.optimizer,
                                global_step, keep=tcfg.checkpoint_keep)
            if max_steps is not None and global_step >= max_steps:
                break
        logger.log_epoch(epoch_logs, epoch)
        if epoch % tcfg.checkpoint_interval == 0:
            save_checkpoint(ckpt_dir, model, step_fn.optimizer, global_step,
                            keep=tcfg.checkpoint_keep)
            save_params(logger.dir / "params_latest.msgpack", model)
        if max_steps is not None and global_step >= max_steps:
            break
    save_checkpoint(ckpt_dir, model, step_fn.optimizer, global_step,
                    keep=tcfg.checkpoint_keep)
    save_params(logger.dir / "params_latest.msgpack", model)
    logger.close()
    return TrainState(model, step_fn.optimizer, global_step)
