"""Z-buffer depth rendering of a mesh at a known pose (LM intrinsics) and
sensor-style degradation. Frozen copy of rasterize_depth, degrade_depth
and their helpers from pose6d_tpu_torch/data/synth.py at commit 653f5ea.
"""
from __future__ import annotations

import numpy as np

FX, FY, CX, CY = 572.4114, 573.57043, 325.2611, 242.049
W, H = 640, 480


def default_intrinsics():
    return np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])


def _rasterize_face_loop(depth, pix, z, faces, w, h):
    """Reference per-face scanline loop (kept for oversized faces)."""
    for f in faces:
        p = pix[f]
        zz = z[f]
        if (zz <= 0).any():
            continue
        lo = np.floor(p.min(0)).astype(int)
        hi = np.ceil(p.max(0)).astype(int) + 1
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, [w, h])
        if (hi <= lo).any():
            continue
        xs = np.arange(lo[0], hi[0])
        ys = np.arange(lo[1], hi[1])
        gx, gy = np.meshgrid(xs, ys)
        a, b, c = p
        det = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(det) < 1e-12:
            continue
        l1 = ((b[1] - c[1]) * (gx - c[0]) + (c[0] - b[0]) * (gy - c[1])) / det
        l2 = ((c[1] - a[1]) * (gx - c[0]) + (a[0] - c[0]) * (gy - c[1])) / det
        l3 = 1 - l1 - l2
        inside = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        if not inside.any():
            continue
        zi = 1.0 / (l1 / zz[0] + l2 / zz[1] + l3 / zz[2])
        patch = depth[lo[1]:hi[1], lo[0]:hi[0]]
        upd = inside & (zi < patch)
        patch[upd] = zi[upd]


def rasterize_depth(verts_mm, faces, R, t_mm, w=W, h=H, max_patch=48):
    """Z-buffer depth render (mm) of a mesh under pose x_cam = R x + t.

    Vectorized: every face whose screen bbox fits a `max_patch`-pixel
    square is rasterized in one batched barycentric evaluation +
    scatter-min (np.minimum.at); the rare larger faces fall back to the
    per-face loop. ~25x faster than the all-loop form at 10k faces,
    identical output.
    """
    cam = verts_mm @ R.T + t_mm
    z = cam[:, 2]
    u = FX * cam[:, 0] / np.maximum(z, 1e-9) + CX
    v = FY * cam[:, 1] / np.maximum(z, 1e-9) + CY
    depth = np.full((h, w), np.inf)
    pix = np.stack([u, v], 1)
    faces = np.asarray(faces)

    tri = pix[faces]                       # (F, 3, 2)
    tz = z[faces]                          # (F, 3)
    ok = (tz > 0).all(1)
    lo = np.floor(tri.min(1)).astype(int)  # (F, 2) x/y
    hi = np.ceil(tri.max(1)).astype(int) + 1
    # off-screen cull
    ok &= (hi[:, 0] > 0) & (hi[:, 1] > 0) & (lo[:, 0] < w) & (lo[:, 1] < h)
    span = (hi - lo).max(1)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    det = ((b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0])
           + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1]))
    ok &= np.abs(det) > 1e-12
    small = ok & (span <= max_patch)

    # Bucket the small faces by power-of-two bbox span so one oversized
    # face can't size the whole batched grid: without this, a single
    # 48-px face among ~10k 2-4-px faces allocates (F, 48, 48) barycentric
    # buffers (~GBs on the 1-CPU host). float32 grid math: at ~1 m depth
    # the zi quantization (~0.06 mm) is far below the 1 mm png unit.
    flat = depth.reshape(-1)
    bucket_lo = 0
    P = 4
    while bucket_lo <= max_patch:
        sel = small & (span > bucket_lo) & (span <= P)
        bucket_lo = P
        P = min(P * 2, max_patch) if P < max_patch else max_patch + 1
        f = np.nonzero(sel)[0]
        if not len(f):
            continue
        Pb = int(span[f].max())
        af, bf, cf, detf, zf = a[f], b[f], c[f], det[f], tz[f]
        gx = (lo[f, 0][:, None, None]
              + np.arange(Pb)[None, None, :]).astype(np.float32)
        gy = (lo[f, 1][:, None, None]
              + np.arange(Pb)[None, :, None]).astype(np.float32)
        dxc = gx - cf[:, 0][:, None, None].astype(np.float32)
        dyc = gy - cf[:, 1][:, None, None].astype(np.float32)
        detf = detf[:, None, None].astype(np.float32)
        l1 = ((bf[:, 1] - cf[:, 1])[:, None, None].astype(np.float32) * dxc
              + (cf[:, 0] - bf[:, 0])[:, None, None].astype(np.float32)
              * dyc) / detf
        l2 = ((cf[:, 1] - af[:, 1])[:, None, None].astype(np.float32) * dxc
              + (af[:, 0] - cf[:, 0])[:, None, None].astype(np.float32)
              * dyc) / detf
        l3 = 1 - l1 - l2
        zf32 = zf.astype(np.float32)
        zi = 1.0 / (l1 / zf32[:, 0][:, None, None]
                    + l2 / zf32[:, 1][:, None, None]
                    + l3 / zf32[:, 2][:, None, None])
        xi = gx.astype(int)
        yi = gy.astype(int)
        use = ((l1 >= 0) & (l2 >= 0) & (l3 >= 0)
               & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
               & np.isfinite(zi) & (zi > 0))
        np.minimum.at(flat, (yi + np.zeros_like(zi, int))[use] * w
                      + (xi + np.zeros_like(zi, int))[use],
                      zi[use].astype(np.float64))

    big = np.nonzero(ok & ~small)[0]
    if len(big):
        _rasterize_face_loop(depth, pix, z, faces[big], w, h)
    depth[~np.isfinite(depth)] = 0
    return depth


def degrade_depth(depth, rng, noise_mm=0.0, hole_frac=0.0):
    """Sensor-style degradation: per-pixel Gaussian noise + dropout blobs.

    Models the two dominant depth-camera artifacts the clean z-buffer
    lacks: measurement noise (~2-3 mm at 1 m for structured-light/ToF)
    and missing-return holes (specular / grazing surfaces). hole_frac is
    the target fraction of valid pixels zeroed by elliptical blobs.
    """
    d = depth.copy()
    m = d > 0
    if noise_mm > 0:
        d[m] += rng.normal(0.0, noise_mm, int(m.sum()))
    if hole_frac > 0 and m.any():
        ys, xs = np.nonzero(m)
        target = hole_frac * len(ys)
        dropped = 0
        gy, gx = np.mgrid[0:d.shape[0], 0:d.shape[1]]
        while dropped < target:
            i = rng.integers(len(ys))
            ry, rx = rng.uniform(2, 9, 2)
            blob = (((gy - ys[i]) / ry) ** 2
                    + ((gx - xs[i]) / rx) ** 2) <= 1.0
            hit = blob & (d > 0)
            dropped += int(hit.sum())
            d[hit] = 0.0
    np.clip(d, 0.0, None, out=d)
    return d

