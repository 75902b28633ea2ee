"""The training loop, on one device or data-parallel over processes
(port of pose6d_tpu/train/loop.py; parallel/ holds the data axis).

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

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import dataset_from_config
from ..data.pipeline import HostLoader, to_device
from ..models import DPFMNet, init_like_flax
from ..models.port_weights import (extend_first_lin_input,
                                   load_reference_checkpoint)
from ..models.weights import (flax_from_state_dict, read_flax_msgpack,
                              state_dict_from_flax)
from ..parallel.mesh import (make_mesh, make_parallel_train_step, replicate,
                             shard_rows)
from ..parallel.multihost import (all_reduce_sum, broadcast_object,
                                  in_group, init_group, worker_threads)
from ..runtime import resolve_device
from ..solvers import naive_fmap2pointmap
from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint, save_params)
from .logging import MetricsLogger
from .metrics import inlier_ratio
from .train_step import TrainStep, make_optimizer

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


def default_width(device) -> int:
    """Data-parallel width of train(n_devices=None): the process group's
    size inside one; else every visible card on CUDA; else 1."""
    if in_group():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def train(cfg, dataset=None, max_steps: int | None = None,
          sample_kw: dict | None = None, device="cuda",
          n_devices: int | None = None) -> TrainState:
    """Run training per config; returns the final TrainState. dataset: a
    sequence of (cad_ops, pc_ops, obj) triples, or None for
    build_train_dataset(cfg) on `device`. sample_kw forwards to
    data.pipeline.make_sample (e.g. smaller v_cad / v_pc padding).

    Data-parallel over n_devices (default_width when None) whenever the
    batch splits evenly over them, else on one device (the JAX package's
    rule). Inside a process group (the CLIs' --coordinator) the group is
    the data axis and n_devices must be its size or 1. Without one,
    train() spawns n_devices worker processes (more than the visible
    cards raises on CUDA), each on its own card, and returns the state
    rebuilt from the final checkpoint; a dataset passed in reaches them
    with its tensors on the CPU, and without one each worker builds it
    on its device. Each process runs its rows of every global batch with
    its rows of the global step draws; rank 0 alone writes the run
    directory."""
    n = default_width(device) if n_devices is None else n_devices
    parallel = n > 1 and cfg.train.batch_size % n == 0
    if in_group():
        world = dist.get_world_size()
        if n not in (1, world):
            raise ValueError(f"n_devices={n} inside a process group of "
                             f"{world}: pass {world} or 1")
        # a group of 1 runs the data-parallel step too (its all-reduce
        # is exact)
        return _train(cfg, dataset, max_steps, sample_kw, device,
                      parallel or (n == world == 1))[0]
    if not parallel:
        return _train(cfg, dataset, max_steps, sample_kw, device, False)[0]
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"n_devices={n}: only {torch.cuda.device_count()} "
                         "CUDA devices are visible")
    return _spawn_train(cfg, dataset, max_steps, sample_kw, device, n)


def _on_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree


def _spawn_train(cfg, dataset, max_steps, sample_kw, device,
                 n: int) -> TrainState:
    """train() over n spawned worker processes (a group over a file
    store); the returned state is the final checkpoint's."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "run_dir"
        with worker_threads(n):
            mp.start_processes(
                _train_worker, nprocs=n, start_method="spawn",
                args=(n, f"file://{tmp}/store", cfg, _on_cpu(dataset),
                      max_steps, sample_kw, torch.device(device).type,
                      str(out)))
        run_dir = Path(out.read_text())
    dev = resolve_device(device)
    model = DPFMNet(cfg.model).to(dev)
    optimizer = make_optimizer(model, cfg.train.lr)
    step = restore_checkpoint(latest_checkpoint(run_dir / "ckpt"), model,
                              optimizer)
    return TrainState(model, optimizer, step)


def _train_worker(rank, n, store, cfg, dataset, max_steps, sample_kw,
                  device, out):
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init_group(store, n, rank, backend)
    try:
        _, run_dir = _train(cfg, dataset, max_steps, sample_kw, device, True)
        if rank == 0:
            Path(out).write_text(str(run_dir))
    finally:
        dist.destroy_process_group()


def _global_mean(x: torch.Tensor, mesh) -> float:
    """The mean of x's elements over every process's x."""
    if mesh is None:
        return float(x.mean())
    s = all_reduce_sum(torch.stack([x.sum(), torch.tensor(
        float(x.numel()), device=x.device)]))
    return float(s[0] / s[1])


def _train(cfg, dataset, max_steps, sample_kw, device, parallel: bool):
    """The training loop of this process: (TrainState, run directory).
    parallel: the data-parallel step over the process group's mesh."""
    dev = resolve_device(device)
    rank = dist.get_rank() if in_group() else 0
    mesh = make_mesh(device=dev) if parallel else None
    if dataset is None:
        dataset = build_train_dataset(cfg, device=dev)
    tcfg = cfg.train
    if max_steps is None:
        max_steps = tcfg.max_steps
    kw = {"v_cad": cfg.pad_v_cad, "v_pc": cfg.pad_v_pc}
    kw.update(sample_kw or {})
    rows = (shard_rows(tcfg.batch_size, mesh) if mesh is not None
            else slice(None))
    loader = HostLoader(dataset, tcfg.batch_size, shuffle=True,
                        seed=tcfg.seed, num_threads=tcfg.num_threads,
                        rows=rows, **kw)
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

    # rank 0 alone writes the run directory; every rank restores the
    # checkpoint it names
    logger = (MetricsLogger(cfg.logging_dir, cfg.comment,
                            run_dir=tcfg.resume_dir) if rank == 0 else None)
    run = logger.dir if logger else None
    latest = latest_checkpoint(run / "ckpt") if logger else None
    if in_group():
        run, latest = broadcast_object((run, latest))
    ckpt_dir = run / "ckpt"
    global_step = 0
    if latest is not None:
        global_step = restore_checkpoint(latest, model, step_fn.optimizer)
        loader.epoch, gen = resume_offsets(global_step, steps_per_epoch,
                                           tcfg.seed, dev)
    if in_group():
        dist.barrier()        # every rank has read the checkpoint
    if mesh is not None:
        replicate(model, mesh)
        step_fn = make_parallel_train_step(step_fn, mesh)
        if logger:
            print(f"train: data-parallel over {mesh.size} devices "
                  f"({tcfg.batch_size // mesh.size} frames/device)")

    def save(params_too: bool):
        if logger:
            save_checkpoint(ckpt_dir, model, step_fn.optimizer, global_step,
                            keep=tcfg.checkpoint_keep)
            if params_too:
                save_params(run / "params_latest.msgpack", model)

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
                logs["IR"] = _global_mean(ir, mesh)
            if logger:
                logger.log(logs, step=global_step)
            epoch_logs.append(logs)
            global_step += 1
            if logger and global_step % tcfg.log_interval == 0:
                print(f"epoch {epoch} step {global_step} "
                      f"loss {logs['loss']:.4f}")
            if (tcfg.checkpoint_every_steps
                    and global_step % tcfg.checkpoint_every_steps == 0):
                save(False)
            if max_steps is not None and global_step >= max_steps:
                break
        if logger:
            logger.log_epoch(epoch_logs, epoch)
        if epoch % tcfg.checkpoint_interval == 0:
            save(True)
        if max_steps is not None and global_step >= max_steps:
            break
    save(True)
    if logger:
        logger.close()
    return TrainState(model, step_fn.optimizer, global_step), run
