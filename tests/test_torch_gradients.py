"""The gradient-feature variant's host and model pieces on the CPU
against the JAX package: the mesh Laplacian and normals, the tangent-
gradient operators of a mesh and of a point cloud (the port's cKDTree
neighbour query against scikit-learn's), their gather form, the padded
pipeline that carries them, and the gather application and its features
in DiffusionNet."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.data import pipeline as jax_pipeline
from pose6d_tpu.models import diffusion_net as jax_dn
from pose6d_tpu.spectral import laplacian as jax_lap
from pose6d_tpu.spectral import operators as jax_ops
from pose6d_tpu_torch.data import pipeline
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.models.diffusion_net import (DiffusionNet,
                                                   SpatialGradientFeatures,
                                                   apply_gather_gradient)
from pose6d_tpu_torch.models.weights import state_dict_from_flax
from pose6d_tpu_torch.spectral import laplacian as lap
from pose6d_tpu_torch.spectral import operators as ops

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    verts, faces = random_shape(5, nu=16, nv=32)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _sparse_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_cotan_laplacian_and_normals_match_jax(mesh):
    """Host numpy on both sides, the same operations: equal bits."""
    verts, faces = mesh
    cots, area = lap._face_cotangents(verts, faces)
    rc, ra = jax_lap._face_cotangents(verts, faces)
    np.testing.assert_array_equal(cots, rc)
    np.testing.assert_array_equal(area, ra)
    L, mass = lap.cotan_laplacian(verts, faces)
    rL, rmass = jax_lap.cotan_laplacian(verts, faces)
    _sparse_equal(L, rL)
    np.testing.assert_array_equal(mass, rmass)
    np.testing.assert_array_equal(lap.vertex_normals(verts, faces),
                                  jax_lap.vertex_normals(verts, faces))


def test_mesh_operators_match_jax(mesh):
    """Everything but the eigenvectors, which ARPACK computes from a
    random start vector: frames, mass, L, normals, faces, gradX / gradY
    and their gather form exactly; the eigenvalues to 1e-5 of the
    largest (ARPACK's tolerance)."""
    verts, faces = mesh
    got = ops.mesh_operators(verts, faces, k_eig=16, build_gradients=True)
    ref = jax_ops.mesh_operators(verts, faces, k_eig=16,
                                 build_gradients=True)
    for key in ("xyz", "frames", "mass", "normals", "faces"):
        np.testing.assert_array_equal(got[key], getattr(ref, key),
                                      err_msg=key)
    _sparse_equal(got["L"], ref.L)
    _sparse_equal(got["gradX"], ref.gradX)
    _sparse_equal(got["gradY"], ref.gradY)
    for a, b in zip((got["grad_idx"], got["grad_cx"], got["grad_cy"]),
                    jax_ops.gradients_to_gather(ref.gradX, ref.gradY)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["evals"], ref.evals, rtol=0,
                               atol=1e-5 * ref.evals.max())


def test_build_gradients_and_gather_match_jax(mesh):
    """_build_gradients on the mesh's one-rings with frames from random
    normals, then gradients_to_gather at a max_nnz below some rows'
    width (the largest-|cx| rule)."""
    verts, faces = mesh
    rng = np.random.default_rng(0)
    n = rng.normal(size=verts.shape)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    tx = np.cross(n, [1.0, 0.0, 0.0])
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    frames = np.stack([tx, np.cross(n, tx), n], axis=1)
    adj = [[] for _ in range(len(verts))]
    for f in faces:
        for a in range(3):
            adj[f[a]].extend([f[(a + 1) % 3], f[(a + 2) % 3]])
    nbrs = [np.unique(a) for a in adj]
    gX, gY = ops._build_gradients(verts, frames, nbrs)
    rX, rY = jax_ops._build_gradients(verts, frames, nbrs)
    _sparse_equal(gX, rX)
    _sparse_equal(gY, rY)
    widths = np.diff(gX.tocsr().indptr)
    assert widths.max() > 6
    for a, b in zip(ops.gradients_to_gather(gX, gY, max_nnz=6),
                    jax_ops.gradients_to_gather(rX, rY, max_nnz=6)):
        np.testing.assert_array_equal(a, b)


def test_point_cloud_gradients_match_sklearn():
    """point_cloud_operators(build_gradients=True): the port queries
    neighbours with scipy's cKDTree, JAX with scikit-learn. The sparse
    rows come out sorted by column, so only the neighbour set matters;
    the two can part only where points tie at the k-th distance, which
    these random points do not (checked). The coefficients then differ
    only by the order of the 2x2 normal equations' sums: 1e-9 of the
    largest."""
    pts = np.random.default_rng(1).normal(size=(300, 3)) * 5
    dist = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    kth = np.sort(dist, axis=1)[:, 29:31]
    assert (kth[:, 1] - kth[:, 0] > 1e-9).all()       # no ties at k = 30
    got = ops.point_cloud_operators(pts, k_eig=16, build_gradients=True)
    ref = jax_ops.point_cloud_operators(pts, k_eig=16, build_gradients=True)
    for a, b in ((got["gradX"], ref.gradX), (got["gradY"], ref.gradY)):
        a, b = a.tocsr(), b.tocsr()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.data, b.data, rtol=0,
                                   atol=1e-9 * np.abs(b.data).max())
    gi, gx, gy = jax_ops.gradients_to_gather(ref.gradX, ref.gradY)
    np.testing.assert_array_equal(got["grad_idx"], gi)
    np.testing.assert_allclose(got["grad_cx"], gx, rtol=0,
                               atol=1e-6 * np.abs(gx).max())
    np.testing.assert_allclose(got["grad_cy"], gy, rtol=0,
                               atol=1e-6 * np.abs(gy).max())
    # without gradients the dict keeps its four keys
    plain = ops.point_cloud_operators(pts, k_eig=16)
    assert sorted(plain) == ["evals", "evecs", "mass", "xyz"]


def test_make_sample_carries_gradients_like_jax(mesh):
    verts, faces = mesh
    cad = ops.mesh_operators(verts * 0.1, faces, k_eig=64,
                             build_gradients=True)
    cad = {k: cad[k] for k in ("xyz", "mass", "evals", "evecs", "grad_idx",
                               "grad_cx", "grad_cy")}
    pc = {k: v[:200] if k != "evals" else v for k, v in cad.items()}
    obj = {"P": np.stack([np.arange(50), np.arange(50)], 1),
           "overlap_12": np.ones(len(verts)), "overlap_21": np.ones(200),
           "align_pc": pc["xyz"], "R_m2c": np.eye(3), "t_m2c": np.zeros(3),
           "diam_cad": 1.0, "obj_id": 1, "visib_fract": 1.0}
    kw = {"v_cad": 640, "v_pc": 256, "nce_pairs": 64}
    a = pipeline.make_sample(cad, pc, obj, np.random.default_rng(0), **kw)
    b = jax_pipeline.make_sample(cad, pc, obj, np.random.default_rng(0),
                                 **kw)
    for side in ("cad", "pc"):
        assert a[side].keys() == b[side].keys()
        assert {"grad_idx", "grad_cx", "grad_cy"} <= a[side].keys()
        for k in a[side]:
            assert a[side][k].dtype == b[side][k].dtype, k
            np.testing.assert_array_equal(a[side][k], b[side][k])
    batch = pipeline.to_device(pipeline.collate([a, a]), "cpu")
    assert batch["cad"]["grad_idx"].dtype == torch.int32
    assert batch["pc"]["grad_cx"].shape == (2, 256, 32)


def _toy_grads(rng, v, n, kn=8):
    idx = rng.integers(0, n, size=(v, kn)).astype(np.int32)
    idx[:, 0] = np.arange(v)
    cx = rng.normal(size=(v, kn)).astype(np.float32) * 0.1
    cy = rng.normal(size=(v, kn)).astype(np.float32) * 0.1
    cx[n:] = 0.0
    cy[n:] = 0.0
    return idx, cx, cy


def test_apply_gather_gradient_matches_jax():
    rng = np.random.default_rng(2)
    idx, cx, _ = _toy_grads(rng, 70, 60)
    x = rng.normal(size=(70, 5)).astype(np.float32)
    ref = jax_dn.apply_gather_gradient(jnp.asarray(cx), jnp.asarray(idx),
                                       jnp.asarray(x))
    got = apply_gather_gradient(*(torch.as_tensor(a)[None]
                                  for a in (cx, idx, x)))
    # a sum of 8 products in another order
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("rotations", [True, False])
def test_spatial_gradient_features_match_jax(rotations):
    rng = np.random.default_rng(3)
    gx, gy = (rng.normal(size=(40, 16)).astype(np.float32) for _ in range(2))
    mod = jax_dn.SpatialGradientFeatures(16, rotations)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(gx), jnp.asarray(gy))
    ref = np.asarray(mod.apply(params, jnp.asarray(gx), jnp.asarray(gy)))
    port = SpatialGradientFeatures(16, rotations)
    sd = state_dict_from_flax(jax.device_get(params)["params"])
    assert sorted(sd) == (["A_im.weight", "A_re.weight"] if rotations
                          else ["A.weight"])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.as_tensor(gx), torch.as_tensor(gy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_diffusion_net_requires_grad_operators():
    net = DiffusionNet(c_in=3, width=8, with_gradient_features=True)
    x = torch.zeros(1, 10, 3)
    with pytest.raises(ValueError, match="requires grad operators"):
        net(x, torch.ones(1, 10), torch.ones(1, 4), torch.zeros(1, 10, 4),
            torch.ones(1, 10, dtype=torch.bool))
    # the MLP takes [x, diffused, gradient features]: 3 x width
    assert net.block_0.mlp.layer_000.in_features == 24
