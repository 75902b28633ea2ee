"""Laplace-Beltrami operators on the host (copy of _face_cotangents,
cotan_laplacian, vertex_normals, point_cloud_laplacian,
pca_normals_and_frames and laplacian_eigenbasis from
pose6d_tpu/spectral/laplacian.py).

One change: the k-nearest-neighbour query uses scipy's cKDTree instead
of scikit-learn, which the GPU host does not carry. Both return each
point itself first, then its neighbours by increasing distance.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.spatial import cKDTree


def _face_cotangents(verts: np.ndarray, faces: np.ndarray):
    """Per-corner cotangents and per-face double areas."""
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    e0, e1, e2 = v2 - v1, v0 - v2, v1 - v0  # edge opposite corner k
    # cot at corner k = dot of adjacent edges / (2 * area)
    n = np.cross(e2, -e1)
    dbl_area = np.linalg.norm(n, axis=1)
    dbl_area = np.maximum(dbl_area, 1e-12)
    cot0 = np.einsum("ij,ij->i", -e1, e2) / dbl_area
    cot1 = np.einsum("ij,ij->i", -e2, e0) / dbl_area
    cot2 = np.einsum("ij,ij->i", -e0, e1) / dbl_area
    return np.stack([cot0, cot1, cot2], axis=1), dbl_area


def cotan_laplacian(verts: np.ndarray, faces: np.ndarray):
    """Cotangent Laplacian L (positive semidefinite) + lumped mass.

    L = D - W with w_ij = (cot a_ij + cot b_ij) / 2; mass_i = 1/3 of the
    area of the incident faces.
    """
    V = len(verts)
    cots, dbl_area = _face_cotangents(verts, faces)
    rows, cols, vals = [], [], []
    for k, (i, j) in enumerate([(1, 2), (2, 0), (0, 1)]):
        w = 0.5 * cots[:, k]
        rows += [faces[:, i], faces[:, j]]
        cols += [faces[:, j], faces[:, i]]
        vals += [w, w]
    W = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(V, V)).tocsr()
    W = 0.5 * (W + W.T)
    d = np.asarray(W.sum(axis=1)).ravel()
    L = sp.diags(d) - W
    mass = np.zeros(V)
    np.add.at(mass, faces.ravel(),
              np.repeat(dbl_area / 6.0, 3))  # dbl_area/2 * 1/3 per corner
    mass = np.maximum(mass, 1e-10 * mass.mean() if mass.mean() > 0 else 1e-12)
    return L.tocsr(), mass


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


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
                         eps: float = 1e-8):
    """Smallest k_eig generalized eigenpairs of L phi = lambda M phi
    (shift-invert eigsh; a dense solve if eigsh fails)."""
    V = L.shape[0]
    k = min(k_eig, V - 2)
    M = sp.diags(mass)
    L_reg = (L + eps * sp.identity(V)).tocsc()
    try:
        evals, evecs = spla.eigsh(L_reg, k=k, M=M, sigma=eps, which="LM")
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
