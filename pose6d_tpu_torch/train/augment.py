"""Train-time rigid augmentation of the partial cloud (port of
pose6d_tpu/train/augment.py).

The LBO eigenbasis is intrinsic, so a rigid motion of pc.xyz keeps the
cached spectral operators and every GT signal valid while the input
features see a new camera-frame pose. Rotation is about the valid-point
centroid, plus a uniform translation jitter; padded rows stay zero.

The draws come in as arguments (axis (B, 3) standard normal, angle (B,)
radians, trans (B, 3) cm), so a test can hand in the JAX package's;
draw_augment makes them from a torch.Generator.
"""
from __future__ import annotations

import torch


def draw_augment(batch_size: int, max_angle: float, trans_jitter: float,
                 generator: torch.Generator, device) -> dict:
    """axis ~ N(0, I), angle ~ U[0, max_angle), trans ~ U[-j, j)^3."""
    kw = {"generator": generator, "device": device}
    return {"axis": torch.randn((batch_size, 3), **kw),
            "angle": torch.rand((batch_size,), **kw) * max_angle,
            "trans": (torch.rand((batch_size, 3), **kw) * 2 - 1)
            * trans_jitter}


def _rotation(axis, angle):
    """Rodrigues: (B, 3) axes (normalized here), (B,) angles -> (B, 3, 3)."""
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-12)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def augment_pc_batch(batch: dict, max_angle: float = 0.0,
                     trans_jitter: float = 0.0, draws: dict | None = None):
    """Return `batch` with pc.xyz rigidly perturbed per sample; the same
    object when both max_angle and trans_jitter are 0."""
    if max_angle <= 0.0 and trans_jitter <= 0.0:
        return batch
    xyz, valid = batch["pc"]["xyz"], batch["pc"]["valid"]
    vf = valid.to(xyz.dtype)[..., None]
    c = (xyz * vf).sum(1, keepdim=True) / torch.clamp(
        vf.sum(1, keepdim=True), min=1.0)
    bsz = xyz.shape[0]
    if max_angle > 0.0:
        R = _rotation(draws["axis"], draws["angle"])
    else:
        R = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(bsz, 3, 3)
    d = (draws["trans"][:, None, :] if trans_jitter > 0.0
         else torch.zeros_like(c))
    moved = (xyz - c) @ R.transpose(-1, -2) + c + d
    out = dict(batch)
    out["pc"] = dict(batch["pc"], xyz=torch.where(vf > 0, moved,
                                                  torch.zeros_like(moved)))
    return out
