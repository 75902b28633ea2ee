"""Quadric-error-metric mesh decimation on the host, at cache-build
time (port of pose6d_tpu/data/decimate.py).

Garland-Heckbert edge collapse with a lazy-deletion heap and union-find,
once per CAD model. The C++ copy in native/ is the default; this Python
version is the oracle, and runs only when the caller asks for it
(use_native=False): a failed native build raises.
"""
from __future__ import annotations

import heapq

import numpy as np


def _face_quadrics(verts, faces):
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    d = -np.einsum("ij,ij->i", n, v0)
    p = np.concatenate([n, d[:, None]], axis=1)  # (F, 4)
    return np.einsum("fi,fj->fij", p, p)         # (F, 4, 4)


def _optimal_point(Q, va, vb):
    A = Q[:3, :3]
    b = -Q[:3, 3]
    # fall back to best of (midpoint, endpoints) if A is near-singular
    try:
        if np.linalg.cond(A) < 1e8:
            v = np.linalg.solve(A, b)
            return v
    except np.linalg.LinAlgError:
        pass
    candidates = [va, vb, 0.5 * (va + vb)]
    costs = [_vertex_cost(Q, c) for c in candidates]
    return candidates[int(np.argmin(costs))]


def _vertex_cost(Q, v):
    vh = np.array([v[0], v[1], v[2], 1.0])
    return float(vh @ Q @ vh)


def decimate_mesh(verts: np.ndarray, faces: np.ndarray,
                  target_faces: int = 10000, use_native: bool = True):
    """Collapse edges until the face count reaches target_faces.

    Returns (new_verts (V',3) float64, new_faces (F',3) int64), from the
    C++ implementation (native/) unless use_native=False.
    """
    verts = np.asarray(verts, np.float64).copy()
    faces = np.asarray(faces, np.int64)
    nf = len(faces)
    if nf <= target_faces:
        return verts, faces.copy()
    if use_native:
        from ..native import decimate_qem
        return decimate_qem(verts, faces, target_faces)

    fq = _face_quadrics(verts, faces)
    nv = len(verts)
    Q = np.zeros((nv, 4, 4))
    for k in range(3):
        np.add.at(Q, faces[:, k], fq)

    # adjacency: vertex -> set of face ids; edges
    vfaces = [set() for _ in range(nv)]
    for fi, f in enumerate(faces):
        for k in range(3):
            vfaces[f[k]].add(fi)
    face_alive = np.ones(nf, bool)
    face_verts = faces.copy()

    parent = np.arange(nv)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    version = np.zeros(nv, np.int64)

    def edge_entry(a, b):
        if a == b:
            return None
        qa = Q[a] + Q[b]
        v = _optimal_point(qa, verts[a], verts[b])
        cost = _vertex_cost(qa, v)
        return (cost, a, b, version[a], version[b], v)

    edges = set()
    for f in faces:
        for i, j in ((0, 1), (1, 2), (2, 0)):
            a, b = int(f[i]), int(f[j])
            edges.add((min(a, b), max(a, b)))
    heap = []
    for a, b in edges:
        e = edge_entry(a, b)
        if e is not None:
            heap.append(e)
    heapq.heapify(heap)

    alive_faces = nf
    while alive_faces > target_faces and heap:
        cost, a, b, va_ver, vb_ver, vnew = heapq.heappop(heap)
        a, b = find(a), find(b)
        if a == b:
            continue
        # stale entry?
        if version[a] != va_ver or version[b] != vb_ver:
            continue
        # collapse b into a
        verts[a] = vnew
        Q[a] = Q[a] + Q[b]
        parent[b] = a
        version[a] += 1
        # merge faces
        dead = vfaces[a] & vfaces[b]
        for fi in dead:
            if face_alive[fi]:
                face_alive[fi] = False
                alive_faces -= 1
        merged = (vfaces[a] | vfaces[b]) - dead
        vfaces[a] = merged
        vfaces[b] = set()
        # re-point faces and collect neighbor vertices
        neighbors = set()
        drop = set()
        for fi in merged:
            if not face_alive[fi]:
                drop.add(fi)
                continue
            fv = face_verts[fi]
            for k in range(3):
                fv[k] = find(fv[k])
            if fv[0] == fv[1] or fv[1] == fv[2] or fv[2] == fv[0]:
                face_alive[fi] = False
                alive_faces -= 1
                drop.add(fi)
                continue
            for k in range(3):
                if fv[k] != a:
                    neighbors.add(int(fv[k]))
        vfaces[a] -= drop
        for nb in neighbors:
            e = edge_entry(a, nb)
            if e is not None:
                heapq.heappush(heap, e)

    # compact output
    out_faces = face_verts[face_alive]
    out_faces = np.vectorize(find)(out_faces) if len(out_faces) else out_faces
    used = np.unique(out_faces)
    remap = np.full(nv, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[out_faces]
