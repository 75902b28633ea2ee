"""Approximate rotational symmetries of a CAD model and the flip bank
of pose disambiguation (host numpy; a copy of
pose6d_tpu/ops/symmetry.py: _nn_dist, _axis_rotation,
detect_symmetries, sym_inlier_ratio, sym_rotation_error_deg,
disambiguation_bank).

Detection runs once per CAD model, when a Predictor is built; nothing
here runs on the device.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

# rotation orders probed per axis, coarse -> fine; if the finest order
# passes the axis is treated as continuously symmetric and discretized
_ORDERS = (2, 3, 4, 6, 8, 12)
_CONTINUOUS_STEPS = 36


def _nn_dist(a, b):
    """Per-row nearest-neighbor distance from a (N,3) to b (M,3), float64.
    A k-d tree (scipy) in place of the JAX package's blocked brute force:
    the same distances, ~100x sooner on 5000-point CADs."""
    return cKDTree(b).query(a, k=1)[0]


def _axis_rotation(axis, angle):
    """Rodrigues rotation matrix about a unit axis."""
    k = np.asarray(axis, dtype=np.float64)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(angle) * K
            + (1.0 - np.cos(angle)) * (K @ K))


def detect_symmetries(verts, rel_tau: float = 0.02, n_samples: int = 1024,
                      orders=_ORDERS, seed: int = 0):
    """Detect approximate rotational symmetries of a vertex set.

    Candidate axes are the PCA eigenvectors of the centered cloud (the
    symmetry axis of a surface of revolution / prism is a principal
    axis; skew symmetry axes of near-degenerate inertia tensors are out
    of scope and documented as such). For each axis the rotation orders
    in `orders` are probed coarse-to-fine: order n passes if the mean
    nearest-neighbor distance from a rotated vertex subsample to the
    full cloud is below ``rel_tau * diameter``. The finest passing
    order wins the axis (its cyclic group contains the coarser ones);
    if that is the last entry the axis is treated as a continuous
    revolution axis and discretized at ``_CONTINUOUS_STEPS``.

    Returns ``(Rs, report)``: Rs (S, 3, 3) float32 rotations about the
    **centroid** with the identity always first, and a list of dicts
    (one per accepted axis) with keys axis, order, continuous,
    residual_rel. Apply to points as ``(p - c) @ R.T + c`` with
    ``c = verts.mean(0)``.
    """
    verts = np.asarray(verts, dtype=np.float64)
    c = verts.mean(0)
    centered = verts - c
    diam = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    if diam <= 0:
        return np.eye(3, dtype=np.float32)[None], []
    rng = np.random.default_rng(seed)
    sub = centered[rng.choice(len(verts), min(n_samples, len(verts)),
                              replace=False)]
    # eigenvectors of the covariance = principal axes
    _, vecs = np.linalg.eigh(np.cov(centered.T))
    Rs = [np.eye(3)]
    report = []
    for ax_i in range(3):
        axis = vecs[:, ax_i]
        best = None
        for n in orders:
            R = _axis_rotation(axis, 2.0 * np.pi / n)
            resid = float(_nn_dist(sub @ R.T, centered).mean()) / diam
            if resid < rel_tau:
                best = (n, resid)
        if best is None:
            continue
        n, resid = best
        continuous = n == orders[-1]
        steps = _CONTINUOUS_STEPS if continuous else n
        for k in range(1, steps):
            Rs.append(_axis_rotation(axis, 2.0 * np.pi * k / steps))
        report.append({"axis": axis.astype(np.float32), "order": n,
                       "continuous": continuous, "residual_rel": resid})
    return np.asarray(Rs, dtype=np.float32), report


def sym_inlier_ratio(p_pred, cad_xyz, align_pc, threshold, Rs,
                     centroid=None):
    """Symmetry-aware inlier ratio over explicit (P, 2) index pairs.

    A pair (i, j) counts as an inlier if ANY rotation in Rs (applied to
    cad point i about the CAD centroid) lands within `threshold` of the
    GT-aligned depth point j. With Rs = identity-only this equals the
    plain inlier ratio on the same pairs.
    """
    p_pred = np.asarray(p_pred)
    if p_pred.size == 0:
        return 0.0
    cad_xyz = np.asarray(cad_xyz, dtype=np.float64)
    c = cad_xyz.mean(0) if centroid is None else np.asarray(centroid)
    a = cad_xyz[p_pred[:, 0]] - c                       # (P, 3)
    b = np.asarray(align_pc, dtype=np.float64)[p_pred[:, 1]] - c
    Rs = np.asarray(Rs, dtype=np.float64)               # (S, 3, 3)
    imgs = np.einsum("sij,pj->spi", Rs, a)              # (S, P, 3)
    d = np.linalg.norm(imgs - b[None], axis=-1).min(0)  # (P,)
    return float((d < threshold).mean())


def sym_rotation_error_deg(R_gt, R_est, Rs):
    """Rotation error modulo a detected symmetry group, in degrees.

    A model-frame symmetry S (rotation about the CAD centroid) makes
    the poses (R, t) and (R S, t + R c - R S c) render identically, so
    the identifiable rotation error is min_S angle(R_est, R_gt S).
    With Rs = identity-only this equals the plain angular error. The
    raw error stays the number of record; this is reported alongside it
    (BOP-style symmetry handling the reference gets implicitly through
    ADD-S, scripts/test_RANSAC.py:203-222).
    """
    R_gt = np.asarray(R_gt, np.float64)
    R_est = np.asarray(R_est, np.float64)
    Rs = np.asarray(Rs, np.float64).reshape(-1, 3, 3)
    # angle(A^T B) via trace, vectorized over the group
    M = np.einsum("ij,sjk->sik", R_gt, Rs)            # (S, 3, 3) R_gt S
    tr = np.einsum("ji,sji->s", R_est, M)             # trace(R_est^T M)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos).min()))


def disambiguation_bank(verts, max_rots: int = 8, rel_tau: float = 0.05):
    """Detected-symmetry flip bank for pose disambiguation.

    The generic bank (solvers/multistart.flip_hypotheses) tests 180-deg
    flips about principal axes regardless of the object; this builds
    the bank from the object's own detected NEAR-symmetries — exactly
    the rotations a functional map confuses (detection at a loose
    rel_tau: a flip only fools the map if the shape ALMOST matches
    under it, and only then is it worth spending an ICP+render slot).
    For a detected continuous (revolution) axis the in-axis images are
    truly unidentifiable, so the bank instead carries 180-deg flips
    about the two perpendicular principal axes (the discrete top/bottom
    ambiguity of a near-cylinder).

    Returns (max_rots, 3, 3) float32: identity first, detected
    near-symmetry images next, identity-padded. Apply about the CAD
    centroid (same contract as detect_symmetries).
    """
    verts = np.asarray(verts, np.float64)
    Rs, report = detect_symmetries(verts, rel_tau=rel_tau)
    bank = [np.eye(3)]
    _, vecs = np.linalg.eigh(np.cov((verts - verts.mean(0)).T))
    for rep in report:
        if rep["continuous"]:
            axis = np.asarray(rep["axis"], np.float64)
            # two perpendicular principal axes -> 180-deg flips
            for k in range(3):
                v = vecs[:, k]
                if abs(float(v @ axis)) < 0.9:
                    bank.append(_axis_rotation(v, np.pi))
        else:
            n = rep["order"]
            for k in range(1, n):
                bank.append(_axis_rotation(rep["axis"],
                                           2.0 * np.pi * k / n))
    # dedup near-identical rotations, keep order
    out = []
    for R in bank:
        if not any(np.abs(R - Q).max() < 1e-3 for Q in out):
            out.append(R)
    if len(out) == 1:
        # nothing detected: fall back to the generic principal-axis
        # bank (180-deg flips about each principal axis + +-90 about
        # the dominant one — the same bank flip_hypotheses builds
        # in-trace), so undetected near-symmetries keep the rescue
        # behavior instead of a no-op identity bank
        for k in range(3):
            out.append(_axis_rotation(vecs[:, k], np.pi))
        out.append(_axis_rotation(vecs[:, 2], np.pi / 2))
        out.append(_axis_rotation(vecs[:, 2], -np.pi / 2))
    out = out[:max_rots]
    while len(out) < max_rots:
        out.append(np.eye(3))
    return np.asarray(out, np.float32)
