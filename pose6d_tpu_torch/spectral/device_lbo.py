"""Spectral operators of a point cloud computed on the device (port of
pose6d_tpu/spectral/device_lbo.py).

A density-normalised heat-kernel graph Laplacian (Coifman-Lafon,
alpha = 1) on the dense kNN graph, and its smallest generalized
eigenpairs by LOBPCG (spectral/lobpcg.py) on the whitened, shifted
operator. Frames carry a leading batch dimension; LOBPCG runs frame by
frame, each with its own stop.
"""
from __future__ import annotations

import torch

from ..ops.geometry import pairwise_sqdist_fma
from ..ops.masking import BIG
from .lobpcg import lobpcg_standard


def graph_laplacian(points, valid, k: int = 16):
    """Dense (B, V, V) Laplacian L and lumped mass (B, V) of padded
    (B, V, 3) clouds; padded rows and columns of L are zero and their
    mass is zero."""
    v = points.shape[1]
    eye = torch.eye(v, dtype=torch.bool, device=points.device)
    d2 = pairwise_sqdist_fma(points, points)
    ok = valid[:, :, None] & valid[:, None, :]
    d2m = torch.where(ok & ~eye, d2, BIG)
    knn_d2 = -torch.topk(-d2m, k, dim=-1).values
    # bandwidth: the mean squared kNN distance
    finite = knn_d2 < BIG * 0.5
    sigma2 = torch.sum(torch.where(finite, knn_d2, 0.0), dim=(1, 2)) / \
        torch.clamp(finite.sum(dim=(1, 2)), min=1.0)
    sigma2 = torch.clamp(sigma2, min=1e-12)[:, None, None]
    w = torch.exp(-d2 / sigma2)
    w = torch.where(ok & ~eye, w, 0.0)
    # keep the weights within either end's kNN radius
    thresh = knn_d2[:, :, -1]
    keep = (d2 <= torch.maximum(thresh[:, :, None], thresh[:, None, :])) & ok
    w = torch.where(keep, w, 0.0)
    q = torch.clamp(w.sum(-1), min=1e-12)
    w = w / (q[:, :, None] * q[:, None, :])
    d = w.sum(-1)
    L = (torch.diag_embed(d) - w) * (4.0 / sigma2)
    mass = torch.where(valid, d, 0.0)
    return torch.where(ok, L, 0.0), mass


def default_x0(v: int, k_eig: int, device) -> torch.Tensor:
    """LOBPCG's start block: normal draws from a CPU generator seeded 0,
    moved to `device`, so that every device starts from the same block."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn((v, k_eig), generator=gen).to(device)


def lobpcg_smallest(L, mass, valid, k_eig: int = 64, iters: int = 80,
                    x0=None):
    """Smallest k_eig generalized eigenpairs of L phi = lambda M phi.

    Whitens with M^-1/2 and shifts (sigma I - A) so that LOBPCG's
    largest k are the smallest of A; padded rows are pushed below the
    shifted spectrum. x0 (V, k_eig) or (B, V, k_eig), optional: the
    start block (default_x0 otherwise). Returns evals (B, k_eig)
    ascending, evecs (B, V, k_eig) M-orthonormal and zero on padding,
    and the iteration count of each frame (a list of 0-d tensors)."""
    bsz, v, _ = L.shape
    dev = L.device
    if x0 is None:
        x0 = default_x0(v, k_eig, dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev).expand(
        bsz, v, k_eig)
    m_isqrt = torch.where(valid, 1.0 / torch.sqrt(torch.clamp(mass,
                                                              min=1e-12)),
                          0.0).float()
    eye = torch.eye(v, dtype=torch.float32, device=dev)
    evals, evecs, counts = [], [], []
    for b in range(bsz):
        a = m_isqrt[b, :, None] * L[b] * m_isqrt[b, None, :]
        a = 0.5 * (a + a.T)
        # Gershgorin bound of the whitened spectrum
        sigma = torch.max(torch.sum(torch.abs(a), dim=1)) + 1.0
        a = a + torch.diag(torch.where(valid[b], 0.0, 2.0 * sigma))
        shifted = sigma * eye - a
        theta, u, n_it = lobpcg_standard(
            shifted, torch.where(valid[b, :, None], x0[b], 0.0), m=iters)
        ev = sigma - theta
        order = torch.argsort(ev, stable=True)
        evals.append(torch.clamp(ev[order], min=0.0))
        evecs.append(torch.where(valid[b, :, None],
                                 m_isqrt[b, :, None] * u[:, order], 0.0))
        counts.append(n_it)
    return torch.stack(evals), torch.stack(evecs), counts


def device_pc_operators(points, valid, k_eig: int = 64, k_nn: int = 16,
                        iters: int = 80, x0=None):
    """Padded (B, V, 3) clouds -> (mass (B, V), evals (B, k_eig),
    evecs (B, V, k_eig)) on their device."""
    L, mass = graph_laplacian(points, valid, k=k_nn)
    evals, evecs, _ = lobpcg_smallest(L, mass, valid, k_eig=k_eig,
                                      iters=iters, x0=x0)
    return mass, evals, evecs
