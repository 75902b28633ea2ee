"""PLY reader and writers (copies of read_ply, write_ply_points and
write_ply_mesh from pose6d_tpu/data/ply.py).

Reads ascii and binary little/big endian (vertices, normals, colors,
faces); writes binary little-endian points and triangle meshes.
"""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Read a PLY file.

    Returns dict with:
      verts (V,3) float64; normals (V,3) or None; colors (V,3) uint8 or
      None; faces (F,3) int64 or None (polygons are fan-triangulated).
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', idx_t, val_t, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(("list", tokens[2], tokens[3], tokens[4]))
                else:
                    elements[-1][2].append((tokens[2], tokens[1]))
            elif tokens[0] == "end_header":
                break
        endian = "<" if fmt == "binary_little_endian" else ">"
        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                out[name] = _read_ascii_element(f, count, props)
            else:
                out[name] = _read_binary_element(f, count, props, endian)

    result = {"verts": None, "normals": None, "colors": None, "faces": None}
    if "vertex" in out:
        v = out["vertex"]
        result["verts"] = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
        if all(k in v for k in ("nx", "ny", "nz")):
            result["normals"] = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
        if all(k in v for k in ("red", "green", "blue")):
            result["colors"] = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.uint8)
    if "face" in out and out["face"]:
        lists = next(iter(out["face"].values()))
        tris = []
        for poly in lists:
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
        result["faces"] = np.asarray(tris, np.int64)
    return result


def _read_ascii_element(f, count, props):
    cols = {p[-1] if p[0] == "list" else p[0]: [] for p in props}
    for _ in range(count):
        tokens = f.readline().split()
        i = 0
        for p in props:
            if p[0] == "list":
                n = int(tokens[i]); i += 1
                cols[p[3]].append([int(float(t)) for t in tokens[i:i + n]])
                i += n
            else:
                cols[p[0]].append(float(tokens[i])); i += 1
    return {k: (v if isinstance(v[0], list) else np.asarray(v))
            for k, v in cols.items() if v}


def _read_binary_element(f, count, props, endian):
    has_list = any(p[0] == "list" for p in props)
    if not has_list:
        dtype = np.dtype([(p[0], endian + _PLY_TYPES[p[1]]) for p in props])
        data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
        return {p[0]: data[p[0]] for p in props}
    # list properties: parse row by row (faces are small)
    cols = {p[-1] if p[0] == "list" else p[0]: [] for p in props}
    for _ in range(count):
        for p in props:
            if p[0] == "list":
                idx_t = np.dtype(endian + _PLY_TYPES[p[1]])
                val_t = np.dtype(endian + _PLY_TYPES[p[2]])
                n = int(np.frombuffer(f.read(idx_t.itemsize), idx_t)[0])
                vals = np.frombuffer(f.read(val_t.itemsize * n), val_t)
                cols[p[3]].append(vals.astype(np.int64).tolist())
            else:
                t = np.dtype(endian + _PLY_TYPES[p[1]])
                cols[p[0]].append(np.frombuffer(f.read(t.itemsize), t)[0])
    return {k: (v if isinstance(v[0], list) else np.asarray(v))
            for k, v in cols.items() if v}


def write_ply_points(path, points, colors=None):
    """Write a point cloud as binary little-endian PLY."""
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    data = np.empty(n, dtype=np.dtype(fields))
    data["x"], data["y"], data["z"] = points.T
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        data["red"], data["green"], data["blue"] = colors.T
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(data.tobytes())


def write_ply_mesh(path, verts, faces):
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z",
               f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(verts.astype("<f4").tobytes())
        rows = np.empty(len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", 3)]))
        rows["n"] = 3
        rows["v"] = faces
        f.write(rows.tobytes())
