"""Data-parallel training and forward over the process group (port of
pose6d_tpu/parallel/mesh.py).

The JAX package compiles its step under GSPMD over a 1-D "data" mesh and
lets XLA insert the gradient psum. Here the mesh is the default process
group, one process per card: a Mesh is its size, this process's rank
and its device. Each process holds a replica of the model, runs its
rows of the global batch, and one all-reduce (SUM) of the flattened
gradients, divided by the size, gives every replica the global-batch
gradient before the unchanged update. Every term of the loss is a batch
mean, so with equal shards this is the single-device gradient up to
summation order.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..runtime import resolve_device
from ..train.train_step import TrainStep, draw_step
from .multihost import (all_gather_rows, all_reduce_sum, collective_device,
                        in_group, rank_and_world)


class Mesh(NamedTuple):
    size: int                # processes along the data axis
    rank: int                # this process's place on it
    device: torch.device     # this process's device


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The 1-D data mesh of the default group (size 1 without one) with
    this process's device (runtime.resolve_device). n_devices, when
    given, must be the group's size."""
    rank, world = rank_and_world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process "
                         f"group of {n_devices}; this one has {world}")
    return Mesh(world, rank, resolve_device(device))


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows [r * n / W, (r + 1) * n / W) of `n`."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.size} processes")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (numpy or tensors), as tensors
    on its device."""
    rows = shard_rows(_leading(batch), mesh)
    return _tree_map(lambda x: torch.as_tensor(x[rows]).to(mesh.device),
                     batch)


def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place)."""
    if mesh.size > 1:
        dev = collective_device()
        with torch.no_grad():
            for t in itertools.chain(model.parameters(), model.buffers()):
                buf = t.detach().to(dev)
                dist.broadcast(buf, 0)
                t.copy_(buf)
    return model


class _ParallelTrainStep:
    """A TrainStep over the mesh, called as one: draw(batch, generator)
    makes the GLOBAL step's draws (draw_step over size x local rows, on
    every rank's identical generator) and __call__(batch, step, draws)
    runs this rank's rows of the batch with its rows of the draws."""

    def __init__(self, step: TrainStep, mesh: Mesh):
        self.step, self.mesh = step, mesh
        self.model, self.optimizer = step.model, step.optimizer

    def draw(self, batch: dict, generator) -> dict:
        n, slots = batch["pairs"].shape[:2]
        return draw_step(n * self.mesh.size, slots, generator,
                         batch["pairs"].device, self.step.augment_angle,
                         self.step.augment_trans)

    def __call__(self, batch: dict, step: int, draws: dict) -> dict:
        ts = self.step
        ts.model.train()
        rows = shard_rows(_leading(draws), self.mesh)
        loss, logs, C = ts.forward_loss(batch, {k: v[rows]
                                                for k, v in draws.items()})
        grads = ts.backward(loss)
        # one all-reduce: the gradients in parameter order, then the
        # logged loss terms, averaged alike
        names = list(logs)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [torch.stack([logs[k].detach() for k in names])])
        if in_group():
            flat = all_reduce_sum(flat)
        flat /= self.mesh.size
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        logs = dict(zip(names, flat[off:]))
        logs["grad_norm"] = ts.apply_update(grads, step)
        logs["_C"] = C.detach()
        return logs


def make_parallel_train_step(step: TrainStep, mesh: Mesh):
    """`step` over the mesh (_ParallelTrainStep), called as a TrainStep."""
    return _ParallelTrainStep(step, mesh)


def make_parallel_forward(fwd, mesh: Mesh):
    """fwd(batch) -> tensor or dict of tensors, run on this rank's rows
    of a global batch, its outputs all-gathered back to the global batch
    on every rank."""
    def run(batch: dict):
        out = fwd(shard_batch(batch, mesh))
        if mesh.size == 1:
            return out
        return _tree_map(all_gather_rows, out)
    return run
