"""Host spectral operators of a point cloud: PCA tangent frames, the
point-cloud cotangent Laplacian with lumped mass, and its smallest
generalized eigenpairs. Frozen copy of pca_normals_and_frames,
point_cloud_laplacian and laplacian_eigenbasis from
pose6d_tpu_torch/spectral/laplacian.py and of point_cloud_operators from
pose6d_tpu_torch/spectral/operators.py at commit 653f5ea.

One change: ARPACK starts from a vector drawn from the caller's seed
(the copied code lets ARPACK draw its own), so the same seed gives the
same operators.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.spatial import cKDTree


def pca_normals_and_frames(points: np.ndarray, k: int = 30):
    """Tangent frames (X, Y, N) per point from local PCA (one batched
    3x3 eigh over all neighbourhoods)."""
    n_pts = len(points)
    kk = min(k, n_pts)
    _, idx = cKDTree(points).query(points, k=kk)
    idx = idx.reshape(n_pts, kk)
    nbr = points[idx]                          # (V, k, 3)
    nbr = nbr - nbr.mean(axis=1, keepdims=True)
    cov = np.einsum("vki,vkj->vij", nbr, nbr)  # (V, 3, 3)
    _, v = np.linalg.eigh(cov)
    normals = v[:, :, 0]
    # orient towards consistent hemisphere (positive z camera convention)
    flip = normals[:, 2] < 0
    normals[flip] *= -1
    ref = np.where(np.abs(normals[:, [0]]) < 0.9,
                   np.array([[1.0, 0, 0]]), np.array([[0, 1.0, 0]]))
    tx = np.cross(normals, ref)
    tx /= np.maximum(np.linalg.norm(tx, axis=1, keepdims=True), 1e-12)
    ty = np.cross(normals, tx)
    frames = np.stack([tx, ty, normals], axis=1)  # (V, 3, 3)
    return normals, frames, idx


def point_cloud_laplacian(points: np.ndarray, k: int = 30):
    """Laplacian + lumped mass for an unstructured point cloud.

    Per point: project its k-neighbourhood to the PCA tangent plane,
    Delaunay-triangulate in 2D, keep the triangles incident to the
    centre point, accumulate their cotan weights and 1/3 areas; the
    accumulated operator is symmetrized.
    """
    from scipy.spatial import Delaunay, QhullError

    n_pts = len(points)
    normals, frames, idx = pca_normals_and_frames(points, k=k)
    local_all = points[idx] - points[:, None, :]
    uv_all = np.einsum("vkj,vcj->vkc", local_all, frames[:, :2])
    ring_tris = []     # (T_i, 3) local neighbour indices, per centre
    ring_center = []   # centre point id, one per triangle
    for i in range(n_pts):
        try:
            tri = Delaunay(uv_all[i])
        except (QhullError, ValueError):
            continue
        simplices = tri.simplices
        ring = simplices[(simplices == 0).any(axis=1)]
        if len(ring) == 0:
            continue
        ring_tris.append(ring)
        ring_center.append(np.full(len(ring), i))
    if not ring_tris:
        raise ValueError("degenerate point cloud: no local triangulations")
    tris = np.concatenate(ring_tris)
    centers = np.concatenate(ring_center)
    tv = uv_all[centers[:, None], tris]        # (T, 3, 2) projected coords
    gidx = idx[centers[:, None], tris]         # (T, 3) global indices
    rows, cols, vals = [], [], []
    for corner, (a, b) in enumerate([(1, 2), (2, 0), (0, 1)]):
        u = tv[:, a] - tv[:, corner]
        w_ = tv[:, b] - tv[:, corner]
        cross = u[:, 0] * w_[:, 1] - u[:, 1] * w_[:, 0]
        dot = np.einsum("ij,ij->i", u, w_)
        cot = np.clip(dot / np.maximum(np.abs(cross), 1e-12), -20.0, 20.0)
        rows.append(gidx[:, a])
        cols.append(gidx[:, b])
        # each triangle appears in ~3 centres' triangulations; with the
        # (W + W^T) / 2 symmetrization, cot/3 recovers 0.5 (cot a + cot b)
        vals.append(cot / 3.0)
    area = 0.5 * np.abs(
        (tv[:, 1, 0] - tv[:, 0, 0]) * (tv[:, 2, 1] - tv[:, 0, 1])
        - (tv[:, 2, 0] - tv[:, 0, 0]) * (tv[:, 1, 1] - tv[:, 0, 1]))
    mass = np.zeros(n_pts)
    np.add.at(mass, centers, area / 3.0)
    W = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_pts, n_pts)).tocsr()
    W = 0.5 * (W + W.T)
    W.data = np.maximum(W.data, 0.0)
    d = np.asarray(W.sum(axis=1)).ravel()
    L = sp.diags(d) - W
    mean_mass = mass[mass > 0].mean() if (mass > 0).any() else 1.0
    mass = np.where(mass <= 0, 1e-3 * mean_mass, mass)
    return L.tocsr(), mass, normals, frames


def laplacian_eigenbasis(L: sp.spmatrix, mass: np.ndarray, k_eig: int,
                         v0_seed: int, eps: float = 1e-8):
    """Smallest k_eig generalized eigenpairs of L phi = lambda M phi
    (shift-invert eigsh from a seeded start vector; a dense solve if
    eigsh fails)."""
    V = L.shape[0]
    k = min(k_eig, V - 2)
    M = sp.diags(mass)
    L_reg = (L + eps * sp.identity(V)).tocsc()
    v0 = np.random.default_rng(v0_seed).uniform(0.5, 1.5, V)
    try:
        evals, evecs = spla.eigsh(L_reg, k=k, M=M, sigma=eps, which="LM",
                                  v0=v0)
    except (spla.ArpackNoConvergence, RuntimeError, ValueError):
        from scipy.linalg import eigh
        evals, evecs = eigh(L_reg.toarray(), np.diag(mass),
                            subset_by_index=[0, k - 1])
    evals = np.clip(evals - eps, 0.0, None)
    order = np.argsort(evals)
    evals, evecs = evals[order], evecs[:, order]
    if k < k_eig:  # pad tiny shapes up to the static basis size
        evals = np.pad(evals, (0, k_eig - k))
        evecs = np.pad(evecs, ((0, 0), (0, k_eig - k)))
    return evals.astype(np.float32), evecs.astype(np.float32)


def point_cloud_operators(points: np.ndarray, v0_seed: int, k_eig: int = 64,
                          k_nn: int = 30) -> dict:
    """{xyz (V, 3), mass (V,), evals (k_eig,), evecs (V, k_eig)}, f32."""
    points = np.asarray(points, np.float64)
    L, mass, _, _ = point_cloud_laplacian(points, k=k_nn)
    evals, evecs = laplacian_eigenbasis(L, mass, k_eig, v0_seed)
    return {"xyz": points.astype(np.float32),
            "mass": mass.astype(np.float32), "evals": evals, "evecs": evecs}
