"""Heat- and wave-kernel-signature point descriptors from the cached
eigenpairs (port of pose6d_tpu/ops/hks.py), batched over a leading
frame axis B.

HKS(v, t) = sum_k exp(-lambda_k t) phi_k(v)^2, the diagonal of the heat
kernel: intrinsic, so exactly invariant to rigid motion of the points.
WKS is its band-pass sibling (Aubry et al.). Both feed the encoder when
DPFMConfig.input_features names them; each channel is normalized to
mass-weighted mean 1 over the valid vertices, so CAD (full) and partial
cloud descriptors live on one scale.
"""
from __future__ import annotations

import torch

from .geometry import fma_f32

_LN10 = 2.302585092994046


def _f32(x: float, like) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def linspace_like_jax(start, stop, num: int):
    """(B,) f32 endpoints -> (B, num) evenly spaced values, rounded as
    jnp.linspace rounds them on the CPU: XLA rewrites start (1 - i / div)
    + stop (i / div) into start c_i + (stop r) i with r = f32(1 / div)
    and c_i = 1 - i r, and contracts the sum into one FMA (the first
    interior point fuses the start's product, the others the stop's);
    the endpoint is `stop` itself. Bit for bit for num <= 33 (measured
    against jax 0.9 on the CPU); HKS and WKS take 16."""
    if num == 1:
        return start[:, None]
    div = num - 1
    r = _f32(1.0, start) / _f32(float(div), start)
    i = torch.arange(div, dtype=torch.float32, device=start.device)
    c = 1.0 - i * r                                   # (div,)
    br = (stop * r)[:, None]                          # (B, 1)
    ac = start[:, None] * c                           # (B, div)
    rest = fma_f32(br.expand_as(ac), i.expand_as(ac), ac)
    cols = [start[:, None]]
    if div > 1:
        cols.append(fma_f32(start[:, None], c[1:2].expand_as(br), br))
        cols.append(rest[:, 2:])
    return torch.cat(cols + [stop[:, None]], dim=1)


def _normalize(h, mass, valid):
    """Each channel of h (B, V, T) to mass-weighted mean 1 over valid
    rows; zero on padded rows."""
    w = (mass * valid).to(h.dtype)
    mean = ((w[..., None] * h).sum(1)
            / torch.clamp(w.sum(1, keepdim=True), min=1e-12))   # (B, T)
    h = h / torch.clamp(mean, min=1e-12)[:, None, :]
    return torch.where(valid[..., None], h, 0.0)


def heat_kernel_signature(evals, evecs, mass, valid, n_t: int = 16):
    """Scaled HKS. evals (B, K) ascending; evecs (B, V, K) zero on padded
    rows; mass (B, V); valid (B, V) bool. Returns (B, V, n_t), zero on
    padded rows. Times log-spaced over [4 ln10 / lambda_max, 4 ln10 /
    lambda_2] per frame."""
    lam = torch.clamp(evals, min=0.0)
    l_lo = torch.clamp(lam[:, 1], min=1e-6)        # skip the ~0 mode
    l_hi = torch.maximum(lam[:, -1], l_lo * 1.01)
    c = _f32(4.0 * _LN10, evals)
    t = torch.exp(linspace_like_jax(torch.log(c / l_hi), torch.log(c / l_lo),
                                    n_t))          # (B, T)
    e = torch.exp(-lam[:, None, :] * t[:, :, None])            # (B, T, K)
    h = (evecs * evecs) @ e.transpose(-1, -2)                  # (B, V, T)
    return _normalize(h, mass, valid)


def wave_kernel_signature(evals, evecs, mass, valid, n_e: int = 16,
                          sigma_scale: float = 7.0):
    """Scaled WKS: n_e energies uniform in log-eigenvalue range, sigma =
    sigma_scale (e_max - e_min) / n_e clipped to [1e-3, (e_max - e_min) /
    5] (so the window [e_min + 2 sigma, e_max - 2 sigma] stays ascending
    at small n_e). Same arguments as heat_kernel_signature; returns (B,
    V, n_e)."""
    lam = torch.clamp(evals, min=1e-6)
    log_l = torch.log(lam)
    e_min, e_max = log_l[:, 1], log_l[:, -1]
    delta = e_max - e_min
    # jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi): hi wins when
    # hi < lo
    sigma = torch.minimum(
        torch.clamp(sigma_scale * delta / n_e, min=1e-3), delta / 5.0)
    e = linspace_like_jax(e_min + 2.0 * sigma, e_max - 2.0 * sigma, n_e)
    g = torch.exp(-0.5 * ((e[:, :, None] - log_l[:, None, :])
                          / sigma[:, None, None]) ** 2)        # (B, E, K)
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-12)
    h = (evecs * evecs) @ g.transpose(-1, -2)                  # (B, V, E)
    return _normalize(h, mass, valid)
