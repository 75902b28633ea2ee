"""One training step: augment -> forward -> loss -> backward -> clip ->
RMSprop (port of pose6d_tpu/train/train_step.py, one device).

The optimizer recipe is the JAX package's: RMSprop with torch semantics
(alpha 0.99, eps 1e-8 outside the sqrt, square average starting at 0,
which is torch.optim.RMSprop), a step decay lr * decay_factor **
(step // decay_every_steps), and optax's clip_by_global_norm arithmetic
(g / norm * max_norm when norm >= max_norm, no epsilon). The random
draws of a step are made in the JAX step's key order, the augmentation's
first and then the loss's (draw_step), or handed in.

The step is split into forward_loss, backward and apply_update so a
caller can time the stages; TrainStep.__call__ runs the three.
"""
from __future__ import annotations

import torch

from .augment import augment_pc_batch, draw_augment
from .loss import DPFMLossConfig, dpfm_loss


def make_optimizer(model: torch.nn.Module, lr: float = 5e-4):
    """torch-semantics RMSprop (the learning rate is set per step)."""
    return torch.optim.RMSprop(model.parameters(), lr=lr, alpha=0.99,
                               eps=1e-8)


def lr_at(step: int, lr: float, decay_factor: float = 0.1,
          decay_every_steps: int = 0) -> float:
    """Step-decay schedule at optimizer update `step` (0-based)."""
    if decay_every_steps > 0:
        return lr * decay_factor ** (step // decay_every_steps)
    return lr


def global_norm(tensors):
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place: scale by max_norm / norm only
    when norm >= max_norm. Returns the norm before clipping."""
    norm = global_norm(grads)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def draw_step(batch_size: int, n_pair_slots: int, generator, device,
              augment_angle: float = 0.0, augment_trans: float = 0.0) -> dict:
    """The random draws of one step, augmentation first, then the NCE
    Gumbel draws (B, n_pair_slots)."""
    draws = {}
    if augment_angle > 0.0 or augment_trans > 0.0:
        draws.update(draw_augment(batch_size, augment_angle, augment_trans,
                                  generator, device))
    u = torch.rand((batch_size, n_pair_slots), generator=generator,
                   device=device)
    tiny = torch.finfo(torch.float32).tiny
    draws["gumbel"] = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return draws


class TrainStep:
    """model + optimizer + recipe; __call__(batch, step, draws) runs one
    step and returns its logs (0-dim tensors, plus _C the step's fmap)."""

    def __init__(self, model, loss_cfg: DPFMLossConfig = DPFMLossConfig(),
                 lr: float = 5e-4, decay_factor: float = 0.1,
                 decay_every_steps: int = 0, clip_norm: float = 5.0,
                 augment_angle: float = 0.0, augment_trans: float = 0.0):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = make_optimizer(model, lr)
        self.lr, self.decay_factor = lr, decay_factor
        self.decay_every_steps = decay_every_steps
        self.clip_norm = clip_norm
        self.augment_angle, self.augment_trans = augment_angle, augment_trans

    def draw(self, batch: dict, generator) -> dict:
        return draw_step(batch["pairs"].shape[0], batch["pairs"].shape[1],
                         generator, batch["pairs"].device,
                         self.augment_angle, self.augment_trans)

    def forward_loss(self, batch: dict, draws: dict):
        """(loss, logs, C) with the autograd graph of the loss."""
        batch = augment_pc_batch(batch, self.augment_angle,
                                 self.augment_trans, draws)
        out = self.model(batch["cad"], batch["pc"])
        loss, logs = dpfm_loss(out, batch, draws["gumbel"], self.loss_cfg)
        return loss, logs, out["C"]

    def backward(self, loss):
        """Gradients of every parameter (a parameter the loss does not
        reach gets zeros, as jax.grad gives it)."""
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in params]

    def apply_update(self, grads, step: int):
        """Clip, then one RMSprop update at the schedule's lr for `step`.
        Returns the gradient norm before clipping."""
        norm = clip_by_global_norm_(grads, self.clip_norm)
        lr = lr_at(step, self.lr, self.decay_factor, self.decay_every_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return norm

    def __call__(self, batch: dict, step: int, draws: dict) -> dict:
        self.model.train()
        loss, logs, C = self.forward_loss(batch, draws)
        grads = self.backward(loss)
        logs = {k: v.detach() for k, v in logs.items()}
        logs["grad_norm"] = self.apply_update(grads, step)
        logs["_C"] = C.detach()
        return logs
