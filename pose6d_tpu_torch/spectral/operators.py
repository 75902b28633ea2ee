"""Host-side spectral operators of a mesh or a point cloud (copy of
_build_gradients, gradients_to_gather, mesh_operators and
point_cloud_operators from pose6d_tpu/spectral/operators.py).

The JAX package returns a ShapeOperators dataclass; the port returns a
dict. point_cloud_operators gives {xyz, frames, mass, evals, evecs},
and with build_gradients also the sparse tangent-gradient operators
gradX / gradY and their gather form grad_idx / grad_cx / grad_cy
(gradients_to_gather, what the gradient-feature model reads; the JAX
package's dataset builds it the same way). mesh_operators gives
ShapeOperators' fields: xyz, frames, mass, L, evals, evecs, faces,
normals, and the same gradient keys with build_gradients.

One change: the point cloud's neighbour query for the gradients uses
scipy's cKDTree instead of scikit-learn, which the GPU host does not
carry. The operators depend on each point's neighbour set, not on its
order (the sparse rows come out sorted by column): the two can part only
where several points tie at the k-th distance.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

from . import laplacian as lap


def _build_gradients(points: np.ndarray, frames: np.ndarray,
                     neighbors: list):
    """Per-vertex least-squares tangent-plane gradient operators.

    For vertex i with neighbour set N(i): the g in R^2 minimizing
    sum_j (<g, u_ij> - (f_j - f_i))^2, u_ij the neighbour offset in i's
    tangent plane. The solution is linear in f: one sparse row of
    (gradX, gradY) each.
    """
    V = len(points)
    rows, cols, vx, vy = [], [], [], []
    for i in range(V):
        nbr = np.asarray(neighbors[i])
        nbr = nbr[nbr != i]
        if len(nbr) < 3:
            continue
        u = (points[nbr] - points[i]) @ frames[i, :2].T  # (k, 2)
        # ridge-regularized normal equations
        A = u.T @ u + 1e-8 * np.eye(2)
        coef = np.linalg.solve(A, u.T)  # (2, k): g = coef @ (f_nbr - f_i)
        rows.append(np.full(len(nbr) + 1, i))
        cols.append(np.concatenate([nbr, [i]]))
        vx.append(np.concatenate([coef[0], [-coef[0].sum()]]))
        vy.append(np.concatenate([coef[1], [-coef[1].sum()]]))
    if not rows:
        empty = sp.csr_matrix((V, V))
        return empty, empty
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    gX = sp.coo_matrix((np.concatenate(vx), (rows, cols)), shape=(V, V)).tocsr()
    gY = sp.coo_matrix((np.concatenate(vy), (rows, cols)), shape=(V, V)).tocsr()
    return gX, gY


def gradients_to_gather(gX: sp.spmatrix, gY: sp.spmatrix,
                        max_nnz: int = 32):
    """Sparse (V, V) gradient operators -> fixed-width gather form for
    the device model: (idx (V, max_nnz) int32, cx, cy (V, max_nnz) f32).

    gradX / gradY share a sparsity pattern (_build_gradients). Rows wider
    than max_nnz keep their largest-|cx| entries; padding gathers row i
    itself with zero coefficient.
    """
    gX = gX.tocsr()
    gY = gY.tocsr()
    V = gX.shape[0]
    idx = np.tile(np.arange(V, dtype=np.int32)[:, None], (1, max_nnz))
    cx = np.zeros((V, max_nnz), np.float32)
    cy = np.zeros((V, max_nnz), np.float32)
    for i in range(V):
        cols = gX.indices[gX.indptr[i]:gX.indptr[i + 1]]
        vx = gX.data[gX.indptr[i]:gX.indptr[i + 1]]
        vy = np.asarray(gY[i, cols].todense()).ravel()
        if len(cols) > max_nnz:
            keep = np.argsort(-np.abs(vx))[:max_nnz]
            cols, vx, vy = cols[keep], vx[keep], vy[keep]
        idx[i, :len(cols)] = cols
        cx[i, :len(cols)] = vx
        cy[i, :len(cols)] = vy
    return idx, cx, cy


def _gradient_keys(gX, gY) -> dict:
    gi, gx, gy = gradients_to_gather(gX, gY)
    return {"gradX": gX, "gradY": gY, "grad_idx": gi, "grad_cx": gx,
            "grad_cy": gy}


def mesh_operators(verts: np.ndarray, faces: np.ndarray, k_eig: int = 64,
                   normals=None, build_gradients: bool = False) -> dict:
    """Cotangent Laplacian, lumped mass, eigenbasis and tangent frames of
    a triangle mesh (and its tangent-gradient operators)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    L, mass = lap.cotan_laplacian(verts, faces)
    evals, evecs = lap.laplacian_eigenbasis(L, mass, k_eig)
    if normals is None:
        normals = lap.vertex_normals(verts, faces)
    # tangent frames from the mesh normals
    ref = np.where(np.abs(normals[:, [0]]) < 0.9,
                   np.array([[1.0, 0, 0]]), np.array([[0, 1.0, 0]]))
    tx = np.cross(normals, ref)
    tx /= np.maximum(np.linalg.norm(tx, axis=1, keepdims=True), 1e-12)
    ty = np.cross(normals, tx)
    frames = np.stack([tx, ty, normals], axis=1)
    out = {"xyz": verts.astype(np.float32), "frames": frames.astype(np.float32),
           "mass": mass.astype(np.float32), "L": L, "evals": evals,
           "evecs": evecs, "faces": faces.astype(np.int32),
           "normals": np.asarray(normals).astype(np.float32)}
    if build_gradients:
        adj = [[] for _ in range(len(verts))]
        for f in faces:
            for a in range(3):
                adj[f[a]].extend([f[(a + 1) % 3], f[(a + 2) % 3]])
        neighbors = [np.unique(a) for a in adj]
        out.update(_gradient_keys(*_build_gradients(verts, frames,
                                                    neighbors)))
    return out


def point_cloud_operators(points: np.ndarray, k_eig: int = 64,
                          k_nn: int = 30,
                          build_gradients: bool = False) -> dict:
    """{xyz (V, 3), frames (V, 3, 3), mass (V,), evals (k_eig,), evecs
    (V, k_eig)}, f32, and with build_gradients the gradient keys (module
    docstring)."""
    points = np.asarray(points, np.float64)
    L, mass, _, frames = lap.point_cloud_laplacian(points, k=k_nn)
    evals, evecs = lap.laplacian_eigenbasis(L, mass, k_eig)
    out = {"xyz": points.astype(np.float32),
           "frames": frames.astype(np.float32),
           "mass": mass.astype(np.float32), "evals": evals, "evecs": evecs}
    if build_gradients:
        k = min(k_nn, len(points))
        _, idx = cKDTree(points).query(points, k=k)
        out.update(_gradient_keys(*_build_gradients(
            points, frames, list(idx.reshape(len(points), k)))))
    return out
