"""The port's evaluation metrics, PLY writers and the plain masked cdist at
ZoomOut's width on the CPU against the JAX package on the same numpy
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu.data import ply as jax_ply
from pose6d_tpu.ops import nn as jax_nn
from pose6d_tpu.train import metrics as jax_metrics
from pose6d_tpu_torch.data import ply
from pose6d_tpu_torch.ops.kernels import (masked_argmin_cdist_plain,
                                          masked_topk_cdist_plain)
from pose6d_tpu_torch.train import metrics

torch.set_num_threads(2)

B, N = 4, 300


def _T(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _poses(depth: float = 0.0):
    """B frames: 300 points of a ~10 cm object (260 valid in frame 1), a
    GT pose placed `depth` cm along z and estimates off by 0.5 to 40 deg
    (the last also 15 cm along x), so that the 0/1 scores take both
    values."""
    rng = np.random.default_rng(4)
    pts = (rng.normal(size=(B, N, 3)) * [5.0, 3.0, 2.0]).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[1, 260:] = False
    T_gt, T_est = [], []
    for b, deg in enumerate((0.5, 3.0, 15.0, 40.0)):
        R = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        t = rng.normal(size=3) * 2 + [0, 0, depth]
        dR = Rotation.from_rotvec(np.deg2rad(deg) * np.array(
            [0.6, 0.0, 0.8])).as_matrix()
        T_gt.append(_T(R, t))
        dt = rng.normal(size=3) * 0.1 * (b + 1) + [15.0 * (b == 3), 0, 0]
        T_est.append(_T(dR @ R, t + dt))
    diam = np.array([12.0, 12.0, 12.0, 8.0], np.float32)
    return (np.stack(T_est), np.stack(T_gt), pts, valid, diam)


def _jax_each(fn, *args):
    """JAX's per-frame function over the batch (numpy in, numpy out)."""
    outs = [fn(*(jnp.asarray(a[b]) for a in args)) for b in range(B)]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs])
                     for i in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ADD distances within 1e-5 relative (f32 sums in another order); ADD-S
# within 1e-4 (measured 1.1e-5): both packages read its nearest-neighbour
# distances from |a|^2 - 2 a.b + |b|^2 in f32, which rounds by ~eps |x|^2
# ~ 2e-6 cm^2 here against squared distances of ~1e-2 cm^2 at 0.5 deg;
# the object near the origin; the 0/1 scores and adds_score_xyz's 1/3
# steps exactly
@pytest.mark.parametrize("name,masked", [
    ("add_distance", True), ("add_distance", False), ("add_score", True),
    ("add_score_xyz", True), ("add_score_xyz", False),
    ("adds_distance", True), ("adds_distance", False), ("adds_score", True),
    ("adds_score_xyz", True), ("adds_score_xyz", False)])
def test_pose_metric_matches_jax(name, masked):
    T_est, T_gt, pts, valid, diam = _poses()
    if name in ("add_distance", "adds_distance"):
        args = (T_est, T_gt, pts) + ((valid,) if masked else ())
    else:
        args = (T_est, T_gt, pts, diam) + ((valid,) if masked else ())
    ref = _jax_each(getattr(jax_metrics, name), *args)
    out = getattr(metrics, name)(*(_t(a) for a in args))
    rtol = 1e-4 if name.startswith("adds") else 1e-5
    if isinstance(ref, tuple):
        np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=rtol)
        np.testing.assert_array_equal(out[1].numpy(), ref[1])
        assert 0 < ref[1].sum() < B       # both outcomes occur
    elif name.endswith("_xyz"):
        np.testing.assert_array_equal(out.numpy(), ref)
        assert len(set(ref.tolist())) > 1
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=rtol)


def test_adds_distance_at_camera_depth():
    """ADD-S with the object 80 cm from the camera, as the pose stage
    scores it: both packages read the nearest-neighbour distances from
    |a|^2 - 2 a.b + |b|^2 in f32, which at |x|^2 ~ 6400 cm^2 rounds by
    ~eps * 6400 ~ 4e-4 cm^2 against squared distances of ~1e-2 cm^2 at
    0.5 deg. Within 1e-3 relative (measured 1.0e-4), the same 0/1
    scores."""
    T_est, T_gt, pts, valid, diam = _poses(depth=80.0)
    ref = _jax_each(jax_metrics.adds_score, T_est, T_gt, pts, diam, valid)
    out = metrics.adds_score(*(_t(a) for a in (T_est, T_gt, pts, diam,
                                               valid)))
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=1e-3)
    np.testing.assert_array_equal(out[1].numpy(), ref[1])


@pytest.mark.parametrize("name", ["angular_error_rad",
                                  "rotation_error_logm_deg",
                                  "translation_error"])
def test_pose_error_matches_jax(name):
    """Within 1e-5 relative; the angles also within arccos's amplification
    of the cosine's f32 rounding, 8 eps / sin(theta) rad (the trace of
    R_gt^T R_est sums f32 products in another order)."""
    T_est, T_gt, *_ = _poses()
    if name == "translation_error":
        args = (T_gt[:, :3, 3], T_est[:, :3, 3])
    else:
        args = (T_gt[:, :3, :3], T_est[:, :3, :3])
    ref = _jax_each(getattr(jax_metrics, name), *args)
    out = getattr(metrics, name)(*(_t(a) for a in args))
    atol = 1e-6
    if name != "translation_error":
        theta = np.deg2rad([0.5, 3.0, 15.0, 40.0])
        atol = 8 * 2.0 ** -24 / np.sin(theta)
        if name == "rotation_error_logm_deg":
            atol = np.degrees(atol * np.sqrt(2.0) / 2.0)
    assert (np.abs(out.numpy() - ref) <= 1e-5 * np.abs(ref) + atol).all(), \
        (out.numpy(), ref)


def test_transform_matches_jax():
    T_est, _, pts, *_ = _poses()
    ref = _jax_each(jax_metrics.transform, pts, T_est)
    np.testing.assert_allclose(metrics.transform(_t(pts), _t(T_est)).numpy(),
                               ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("writer", ["points", "mesh"])
def test_ply_writers_match_jax_bytes(tmp_path, writer):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(57, 3))
    if writer == "points":
        args = (verts,)
        jax_ply.write_ply_points(tmp_path / "a.ply", *args)
        ply.write_ply_points(tmp_path / "b.ply", *args)
    else:
        faces = rng.integers(0, 57, size=(40, 3))
        jax_ply.write_ply_mesh(tmp_path / "a.ply", verts, faces)
        ply.write_ply_mesh(tmp_path / "b.ply", verts, faces)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply"
                                                 ).read_bytes()
    back = ply.read_ply(tmp_path / "b.ply")["verts"]
    np.testing.assert_array_equal(back, verts.astype(np.float32))


def _grid(shape, rng):
    """Normal draws rounded to 2^-10 and clipped at 0.125: every product
    and sum of the distance expansion is exact in f32 in any order, so
    the port and JAX must agree bit for bit, exact ties included."""
    x = rng.normal(size=shape) * 0.05
    return np.clip(np.round(x * 1024) / 1024, -0.125, 0.125
                   ).astype(np.float32)


@pytest.mark.parametrize("c", [48, 64])
def test_plain_cdist_wide_matches_jax(c):
    """ZoomOut's widths (34 to 64 features; the ZoomOut candidate's top-5
    at 64): the plain argmin and top-5 against JAX's nearest_valid and
    topk_valid, equal d2 and indices, with ties and masked columns."""
    rng = np.random.default_rng(c)
    a = _grid((2, 96, c), rng)
    b = _grid((2, 160, c), rng)
    b[:, 1:40:2] = b[:, 0:40:2]                  # exact ties
    bv = rng.random((2, 160)) < 0.8
    bv[1, :] = False
    bv[1, [3, 90, 150]] = True                   # 3 valid: top-5 fill
    d_arg, i_arg = masked_argmin_cdist_plain(_t(a), _t(b), _t(bv))
    d_top, i_top = masked_topk_cdist_plain(_t(a), _t(b), _t(bv), k=5)
    for f in range(2):
        jd, ji = jax_nn.nearest_valid(jnp.asarray(a[f]), jnp.asarray(b[f]),
                                      jnp.asarray(bv[f]))
        np.testing.assert_array_equal(i_arg[f].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d_arg[f].numpy(), np.asarray(jd))
        jd, ji = jax_nn.topk_valid(jnp.asarray(a[f]), jnp.asarray(b[f]),
                                   jnp.asarray(bv[f]), k=5)
        np.testing.assert_array_equal(i_top[f].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d_top[f].numpy(), np.asarray(jd))
    assert jax.default_backend() == "cpu"
