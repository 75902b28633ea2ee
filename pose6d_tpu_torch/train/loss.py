"""Training losses: Frobenius fmap + weighted-BCE overlap + NCE contrastive
(port of pose6d_tpu/train/loss.py, batched over a leading B).

The NCE subsample is the top-k of Gumbel-perturbed scores over the
valid slots of the pair buffer (uniform sampling without replacement).
The Gumbel draws come in as an argument, (B, pair buffer), so a test
can hand in the JAX package's draws; train_step draws them from a
torch.Generator.

The NCE gathers the features of the subsampled pairs, and a CAD or PC
point can appear in several pairs. torch.gather's backward on the card
adds those rows' gradients with atomics, in an order that changes from
run to run, so two runs of one seed would part after the first step; on
the card the gather's backward here is index_put_ with accumulate=True,
the sort-based variant that PyTorch's deterministic mode takes for it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.geometry import pairwise_sqdist


@dataclasses.dataclass(frozen=True)
class DPFMLossConfig:
    w_fmap: float = 1.0
    w_acc: float = 1.0
    w_nce: float = 1.0
    nce_t: float = 0.07
    nce_num_pairs: int = 512


def _masked_mean(x, mask, dim=-1, eps: float = 1e-12):
    mask = mask.to(x.dtype)
    return (x * mask).sum(dim) / (mask.sum(dim) + eps)


def frobenius_loss(C_pred, C_gt):
    """Per-sample clamped squared Frobenius distance (B,)."""
    return torch.clamp(((C_pred - C_gt) ** 2).sum((-2, -1)), -1.0, 1000.0)


def weighted_bce(pred, gt, valid, eps: float = 1e-7):
    """Class-frequency-weighted BCE over valid points, per sample (B,).
    pred, gt (B, V) float, valid (B, V) bool."""
    gt = gt.float()
    p = torch.clamp(pred, eps, 1.0 - eps)
    bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    w_neg = _masked_mean(gt, valid)[:, None]     # fraction of positives
    w = torch.where(gt >= 0.5, 1.0 - w_neg, w_neg)
    return _masked_mean(w * bce, valid)


def _l2n(f):
    # eps inside the sqrt: zero (padded) rows must not give NaN grads
    return f * torch.rsqrt((f * f).sum(-1, keepdim=True) + 1e-12)


class _GatherRows(torch.autograd.Function):
    """torch.gather of whole rows, whose backward sums the gradients of
    repeated rows in a fixed order (index_put_ with accumulate=True)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape)
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        out.index_put_((rows.expand_as(idx), idx), grad, accumulate=True)
        return out, None


def gather_rows(x, idx):
    """x (B, V, C), idx (B, N) int64 -> x's rows (B, N, C); on the card
    with a backward that repeats bit for bit (see the module note)."""
    if x.device.type == "cuda" and x.requires_grad:
        return _GatherRows.apply(x, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def nce_softmax_loss(gumbel, feat1, feat2, pairs, pairs_valid, nce_t: float,
                     num_pairs: int):
    """InfoNCE over a subsample of GT pairs, per sample (B,).

    gumbel (B, P) Gumbel draws; feat1 (B, V1, C) CAD features, feat2
    (B, V2, C) PC features; pairs (B, P, 2) int [cad_idx, pc_idx];
    pairs_valid (B, P) bool.
    """
    score = torch.where(pairs_valid, gumbel,
                        torch.full_like(gumbel, -torch.inf))
    sel = torch.topk(score, num_pairs, dim=-1).indices
    sel_valid = torch.gather(pairs_valid, 1, sel)
    q_idx = torch.gather(pairs[..., 0].long(), 1, sel)
    k_idx = torch.gather(pairs[..., 1].long(), 1, sel)
    q = gather_rows(_l2n(feat1), q_idx)
    k = gather_rows(_l2n(feat2), k_idx)
    d = torch.sqrt(torch.clamp(pairwise_sqdist(q, k), min=1e-12))
    logits = -d / nce_t
    # invalid keys must not act as negatives
    logits = torch.where(sel_valid[:, None, :], logits,
                         torch.full_like(logits, -torch.inf))
    diag = torch.diagonal(torch.log_softmax(logits, dim=-1), dim1=-2,
                          dim2=-1)
    # where, not a product: an invalid slot's diagonal is -inf
    diag = torch.where(sel_valid, diag, torch.zeros_like(diag))
    return -_masked_mean(diag, sel_valid)


def solve_c_gt(cgt_A, cgt_B, ridge: float = 1e-6):
    """C_gt from the precomputed normal equations, (B, K, K)."""
    k = cgt_A.shape[-1]
    eye = torch.eye(k, dtype=cgt_A.dtype, device=cgt_A.device)
    return torch.linalg.solve(cgt_A + ridge * eye, cgt_B)


def dpfm_loss(out: dict, batch: dict, gumbel,
              cfg: DPFMLossConfig = DPFMLossConfig()):
    """Total loss over a batch; out = DPFMNet outputs, batch = collated
    pipeline batch on the same device, gumbel (B, pair buffer). Returns
    (loss, logs dict of 0-dim tensors)."""
    C_gt = solve_c_gt(batch["cgt_A"], batch["cgt_B"])
    fmap = frobenius_loss(out["C"], C_gt).mean() * cfg.w_fmap
    acc = weighted_bce(out["overlap12"], batch["overlap12"],
                       batch["cad"]["valid"])
    acc = acc + weighted_bce(out["overlap21"], batch["overlap21"],
                             batch["pc"]["valid"])
    acc_loss = acc.mean() * cfg.w_acc
    nce = nce_softmax_loss(gumbel, out["feat1"], out["feat2"],
                           batch["pairs"], batch["pairs_valid"], cfg.nce_t,
                           cfg.nce_num_pairs)
    nce_loss = nce.mean() * cfg.w_nce
    total = fmap + acc_loss + nce_loss
    return total, {"loss": total, "fmap_loss": fmap, "acc_loss": acc_loss,
                   "nce_loss": nce_loss}
