"""ZoomOut spectral upsampling of a predicted functional map (port of
pose6d_tpu/solvers/zoomout.py, batched over a leading B).

Melzi et al., "ZoomOut" (SIGGRAPH Asia 2019): alternate between (a) the
pointwise map of the current functional map and (b) a refit of the
functional map on those matches in a larger spectral basis, growing it
from the network's n_fmap to the cached basis width (eval.zoomout_k).

Each round's nearest-neighbour step runs at the full width k1 through
ops/nn.nearest_valid (the masked argmin kernel on the card, C = k1):
the map's zero rows beyond the current size add a per-row constant to
every distance, which cannot change the argmin. A gated round also
scores every match's pairwise-distance consistency (_consistency_mean:
masked_consistency_sum, the PC-major kernel, on the card).
"""
from __future__ import annotations

import torch

from ..ops.kernels.consistency import masked_consistency_sum
from ..ops.nn import nearest_valid


def _gather_rows(x, idx):
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))


def _consistency_mean(ca, cb, row_valid):
    """mean_i |d(ca_i, ca_j) - d(cb_i, cb_j)| over valid rows i, per match
    j. ca, cb (B, P, 3); row_valid (B, P)."""
    w = row_valid.float()
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    return masked_consistency_sum(ca, cb, w) / denom


def zoomout_refine(C0, evecs_x, evecs_y, x_valid, y_valid, step: int = 4,
                   ridge: float = 1e-6, cad_xyz=None, pc_xyz=None,
                   diam=None, gate_tau: float = 0.0):
    """Grow C0 (B, k0, k0) to (B, k1, k1), k1 = evecs width, in rounds
    k0 + step, k0 + 2 step, ..., k1.

    evecs_x (B, V1, k1) CAD eigenvectors, evecs_y (B, V2, k1) PC
    eigenvectors; x_valid (B, V1), y_valid (B, V2). With cad_xyz
    (B, V1, 3), pc_xyz (B, V2, 3), diam (B,) and gate_tau > 0, each
    round refits only on matches whose consistency mean is below
    gate_tau * diam (all valid rows when fewer than the round's width
    pass). Returns C (B, k1, k1), CAD -> PC.
    """
    bsz, k0 = C0.shape[:2]
    k1 = evecs_x.shape[-1]
    if k1 < k0:
        raise ValueError(f"evecs width {k1} < map size {k0}")
    dev = C0.device
    ex = evecs_x.float()
    ey = evecs_y.float().contiguous()
    C = torch.zeros((bsz, k1, k1), device=dev)
    C[:, :k0, :k0] = C0.float()
    wy0 = y_valid.float()[..., None]
    gated = gate_tau > 0.0 and cad_xyz is not None
    if gated:
        diam = torch.as_tensor(diam, dtype=torch.float32,
                               device=dev).expand(bsz)
    for kn in list(range(k0 + step, k1, step)) + [k1]:
        _, p2p = nearest_valid(ey, ex @ C.transpose(-1, -2), x_valid)
        wy = wy0
        if gated:
            m = _consistency_mean(_gather_rows(cad_xyz, p2p), pc_xyz,
                                  y_valid)
            keep = (m < gate_tau * diam[:, None]).float()[..., None] * wy0
            # fall back to the ungated rows if the gate starved the refit
            enough = keep.sum((1, 2)) >= kn
            wy = torch.where(enough[:, None, None], keep, wy0)
        A = _gather_rows(ex, p2p)[..., :kn]
        Aw = A * wy
        M = A.transpose(-1, -2) @ Aw + ridge * torch.eye(kn, device=dev)
        N = Aw.transpose(-1, -2) @ ey[..., :kn]
        C = torch.zeros((bsz, k1, k1), device=dev)
        C[:, :kn, :kn] = torch.linalg.solve(M, N).transpose(-1, -2)
    return C
