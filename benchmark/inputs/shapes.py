"""Procedural CAD meshes: superquadrics with radial bumps, taper and
twist, at LM-like scale. Frozen copy of pose6d_tpu_torch/data/shapes.py
at commit 653f5ea (numpy only), kept here so that the inputs do not move
when the program does.
"""
from __future__ import annotations

import numpy as np


def _spow(u, e):
    """Signed power |u|^e * sign(u) (superquadric primitive)."""
    return np.sign(u) * np.abs(u) ** e


def superquadric_grid(e1: float, e2: float, scales, nu: int = 48,
                      nv: int = 96):
    """Superquadric surface samples on an (nu, nv) (eta, omega) grid.

    Returns verts (nu*nv, 3) with eta in (-pi/2, pi/2) exclusive (pole
    rings handled separately by mesh_from_grid's fans).
    """
    sx, sy, sz = scales
    eta = np.linspace(-np.pi / 2, np.pi / 2, nu + 2)[1:-1]
    omega = np.linspace(-np.pi, np.pi, nv, endpoint=False)
    E, W = np.meshgrid(eta, omega, indexing="ij")
    ce, se = np.cos(E), np.sin(E)
    cw, sw = np.cos(W), np.sin(W)
    x = sx * _spow(ce, e1) * _spow(cw, e2)
    y = sy * _spow(ce, e1) * _spow(sw, e2)
    z = sz * _spow(se, e1)
    return np.stack([x, y, z], axis=-1).reshape(-1, 3), nu, nv


def mesh_from_grid(verts, nu, nv, pole_lo, pole_hi):
    """Triangulate an (nu, nv) wrap-around grid plus two pole fans.

    verts (nu*nv, 3); pole_lo/pole_hi (3,) apex points. Watertight:
    every grid edge is shared by exactly two triangles, poles close the
    boundary rings with fans.
    """
    v = np.concatenate([verts, [pole_lo], [pole_hi]], axis=0)
    i_lo = nu * nv
    i_hi = nu * nv + 1
    idx = np.arange(nu * nv).reshape(nu, nv)
    faces = []
    nxt = np.roll(np.arange(nv), -1)
    for r in range(nu - 1):
        a, b = idx[r], idx[r + 1]
        faces.append(np.stack([a, b, a[nxt]], axis=1))
        faces.append(np.stack([a[nxt], b, b[nxt]], axis=1))
    a = idx[0]
    faces.append(np.stack([a[nxt], a, np.full(nv, i_lo)], axis=1))
    b = idx[-1]
    faces.append(np.stack([b, b[nxt], np.full(nv, i_hi)], axis=1))
    return v.astype(np.float32), np.concatenate(faces).astype(np.int32)


def _radial_bumps(verts, rng, n_bumps, amp, sig_range):
    dirs = verts / np.maximum(np.linalg.norm(verts, axis=1, keepdims=True),
                              1e-9)
    scale = np.ones(len(verts))
    for _ in range(n_bumps):
        c = rng.normal(size=3)
        c /= np.linalg.norm(c)
        a = rng.uniform(-amp, amp * 1.5)
        sig = rng.uniform(*sig_range)
        ang2 = np.sum((dirs - c) ** 2, axis=1)    # chordal distance^2
        scale = scale + a * np.exp(-0.5 * ang2 / sig ** 2)
    return verts * np.clip(scale, 0.35, None)[:, None]


def random_shape(seed: int, nu: int = 48, nv: int = 96,
                 diam_range=(80.0, 300.0)):
    """One random watertight mesh, LM-scale (mm). Returns (verts, faces).

    Deterministic in `seed`; distinct seeds give distinct shape-family
    draws (superquadric exponents, anisotropic scales, bumps, taper,
    twist).
    """
    rng = np.random.default_rng(seed)
    e1 = rng.uniform(0.3, 1.8)
    e2 = rng.uniform(0.3, 1.8)
    scales = rng.uniform(0.35, 1.0, size=3)
    verts, gu, gv = superquadric_grid(e1, e2, scales, nu, nv)
    pole_lo = np.array([0.0, 0.0, -scales[2]])
    pole_hi = np.array([0.0, 0.0, scales[2]])
    v, f = mesh_from_grid(verts, gu, gv, pole_lo, pole_hi)

    v = _radial_bumps(v, rng, n_bumps=rng.integers(2, 6),
                      amp=rng.uniform(0.08, 0.30),
                      sig_range=(0.25, 0.7))
    # taper along z (keeps faces, smooth diffeomorphism)
    tz = rng.uniform(-0.5, 0.5)
    zn = v[:, 2] / np.maximum(np.abs(v[:, 2]).max(), 1e-9)
    v[:, :2] *= (1.0 + tz * zn)[:, None]
    # twist about z
    tw = rng.uniform(-0.9, 0.9)
    ang = tw * zn
    ca, sa = np.cos(ang), np.sin(ang)
    x, y = v[:, 0].copy(), v[:, 1].copy()
    v[:, 0] = ca * x - sa * y
    v[:, 1] = sa * x + ca * y

    # scale to a target diameter (max pairwise distance, via hull)
    target = rng.uniform(*diam_range)
    v *= target / _diameter(v)
    v -= v.mean(axis=0, keepdims=True)
    return v.astype(np.float32), f


def _diameter(verts):
    try:
        from scipy.spatial import ConvexHull
        pts = verts[ConvexHull(verts).vertices]
    except Exception:
        sub = verts[:: max(1, len(verts) // 512)]
        pts = sub
    d2 = np.sum((pts[:, None] - pts[None]) ** 2, axis=-1)
    return float(np.sqrt(d2.max()))


def diameter(verts):
    """Max pairwise vertex distance (BOP models_info 'diameter', mm)."""
    return _diameter(verts)
