"""The remaining solver options on the CPU against the JAX package on the
same numpy inputs: Kabsch with method="svd", RANSAC with a sample size
other than 3 (shared draws), and grouped FPS (the picks exactly, alone
and in Predictor(fps_groups=8)'s cloud stage on a small online frame)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from scipy.spatial.transform import Rotation

import pose6d_tpu.api as jax_api
import pose6d_tpu_torch.api as torch_api
from pose6d_tpu import solvers as jax_solvers
from pose6d_tpu.api import Predictor as JaxPredictor
from pose6d_tpu.ops import sampling as jax_sampling
from pose6d_tpu.solvers import kabsch as jax_kabsch
from pose6d_tpu_torch import solvers
from pose6d_tpu_torch.api import Predictor
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.data.synth import default_intrinsics, rasterize_depth
from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.ops import geometry, sampling
from pose6d_tpu_torch.solvers import kabsch
from pose6d_tpu_torch.spectral.operators import point_cloud_operators

from test_torch_api import CKPT
from test_torch_online import _cloud
from test_torch_solvers import _rotation

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("case", ["plain", "weighted", "reflection_prone",
                                  "zero_weights"])
def test_kabsch_svd_matches_jax(case):
    """method="svd" against JAX's: U S V^T with the determinant's sign.
    "reflection_prone": a nearly planar set, where the plain SVD
    solution is a reflection without the sign fix."""
    rng = np.random.default_rng(6)
    R_gt = _rotation(rng)
    src = rng.normal(size=(4, 50, 3)).astype(np.float32) * 3
    if case == "reflection_prone":
        src[..., 2] *= 1e-3
    dst = (src @ R_gt.T + np.array([1.0, -2.0, 0.5], np.float32)
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    w = np.ones((4, 50), np.float32)
    if case == "weighted":
        w = rng.random((4, 50)).astype(np.float32)
    elif case == "zero_weights":
        w = np.zeros((4, 50), np.float32)
    jR, jt = jax.vmap(lambda s, d, ww: jax_kabsch.kabsch_umeyama(
        s, d, ww, method="svd"))(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w))
    R, t = kabsch.kabsch_umeyama(_t(src), _t(dst), _t(w), method="svd")
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    # proper rotations; two f32 SVDs of a well-separated spectrum agree
    # to f32 precision (the all-zero case: the jitter's identity)
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    if case != "zero_weights":
        Rq, _ = kabsch.kabsch_umeyama(_t(src), _t(dst), _t(w))
        np.testing.assert_allclose(R.numpy(), Rq.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="method"):
        kabsch.kabsch_umeyama(_t(src), _t(dst), _t(w), method="eig")


def _jax_uniforms(key, n_blocks, hyp_block, sample_size):
    """The draws ransac_pose makes: split the key once per block, then
    one uniform (hyp_block, sample_size) draw from the sub-key."""
    out = []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            sub, (hyp_block, sample_size))))
    return np.stack(out)


def test_ransac_sample_size_4_matches_jax_with_shared_draws():
    """4-point hypotheses solved by Kabsch, the bound at eps ** 4: two
    frames (60 % and 30 % inliers) exit after JAX's block counts, with
    its inlier counts and pose."""
    rng = np.random.default_rng(8)
    n, n_hyp, hyp_block, s = 300, 2048, 64, 4
    srcs, dsts, valids, us, refs = [], [], [], [], []
    for f, ratio in enumerate((0.6, 0.3)):
        src = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
        dst = src @ _rotation(rng).T + np.array([3.0, 1.0, 40.0],
                                                np.float32)
        out = rng.random(n) > ratio
        dst[out] = rng.normal(size=(out.sum(), 3)) * 5 + 40
        dst = dst.astype(np.float32)
        valid = np.arange(n) < 280
        key = jax.random.PRNGKey(10 + f)
        refs.append(jax_solvers.ransac_pose(
            key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
            threshold=0.5, n_hypotheses=n_hyp, hyp_block=hyp_block,
            sample_size=s))
        srcs.append(src), dsts.append(dst), valids.append(valid)
        us.append(_jax_uniforms(key, n_hyp // hyp_block, hyp_block, s))
    res = solvers.ransac_pose(_t(np.stack(srcs)), _t(np.stack(dsts)),
                              _t(np.stack(valids)), threshold=0.5,
                              n_hypotheses=n_hyp, hyp_block=hyp_block,
                              uniforms=_t(np.stack(us)), sample_size=s)
    trials = [int(r["n_trials"]) for r in refs]
    assert trials[0] < trials[1]
    for f, ref in enumerate(refs):
        assert int(res["n_trials"][f]) == trials[f]
        assert int(res["n_inliers"][f]) == int(ref["n_inliers"])
        # the same winning hypothesis, then two f32 least-squares refits
        np.testing.assert_allclose(res["R"][f].numpy(), np.asarray(ref["R"]),
                                   atol=1e-4)
        np.testing.assert_allclose(res["t"][f].numpy(), np.asarray(ref["t"]),
                                   atol=1e-4 * 50)   # 1e-4 of |t| ~ 40


@pytest.mark.parametrize("n,n_valid,n_samples,groups",
                         [(1024, 900, 200, 8), (1024, 150, 200, 8),
                          (1000, 700, 100, 4), (512, 512, 64, 8)])
def test_grouped_fps_matches_jax(n, n_valid, n_samples, groups):
    """Identical indices and valid masks, stratum by stratum, batched
    over two frames (the port runs all strata of both as one chain);
    150 valid points under 200 samples leave strata short."""
    frames = [_cloud(30 + f, n, n_valid, outliers=0) for f in range(2)]
    for pts, valid in frames:
        valid[::7] = False
    idx, sel = sampling.farthest_point_sample_grouped(
        _t(np.stack([p for p, _ in frames])),
        _t(np.stack([v for _, v in frames])), n_samples, groups=groups)
    assert idx.shape == sel.shape == (2, n_samples)
    for f, (pts, valid) in enumerate(frames):
        ref_i, ref_v = jax_sampling.farthest_point_sample_grouped(
            jnp.asarray(pts), jnp.asarray(valid), n_samples, groups=groups)
        np.testing.assert_array_equal(idx[f].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(sel[f].numpy(), np.asarray(ref_v))
        assert valid[idx[f].numpy()[sel[f].numpy()]].all()
    with pytest.raises(ValueError, match="divisible"):
        sampling.farthest_point_sample_grouped(
            _t(frames[0][0])[None], _t(frames[0][1])[None], 100, groups=3)


def test_predictor_grouped_fps_cloud_matches_jax(monkeypatch):
    """Predictor(fps_groups=8) on a small rasterized random_shape frame
    (tests/test_torch_online.py's construction, 496 points sampled from
    4096): its cloud stage (backprojection, outliers, grouped FPS)
    equals JAX's Predictor's exactly, and predict() runs on it; with
    max_pc not divisible by the groups both fall back to exact FPS."""
    seed = 12
    verts, faces = random_shape(seed, nu=16, nv=32)
    verts = verts * (140.0 / np.linalg.norm(verts.max(0) - verts.min(0)))
    rng = np.random.default_rng(seed)
    R_gt = Rotation.from_rotvec(rng.normal(size=3) * 0.9).as_matrix()
    t_gt = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                     rng.uniform(900, 1200)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        depth = rasterize_depth(verts, faces, R_gt, t_gt).astype(np.uint16)
    mask = depth > 0
    K = default_intrinsics()
    cad_ops = point_cloud_operators(verts * 0.1)
    monkeypatch.setattr(jax_api, "MAX_RAW", 4096)
    monkeypatch.setattr(torch_api, "MAX_RAW", 4096)
    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    model = load_flax_checkpoint(CKPT, DPFMNet())
    args = (_t(depth.astype(np.float32))[None],
            _t(K.astype(np.float32))[None], 1000.0, _t(mask)[None])
    jargs = (jnp.asarray(depth), jnp.asarray(K, jnp.float32), 1000.0,
             jnp.asarray(mask))
    for max_pc, grouped in ((496, True), (500, False)):
        sizes = dict(v_cad=640, v_pc=512, max_pc=max_pc, fps_groups=8,
                     ransac_hypotheses=512, icp_iters=3, lobpcg_iters=20,
                     disambiguate=False)
        jp = JaxPredictor(params, {seed: cad_ops}, mode="online", **sizes)
        pred = Predictor(model, {seed: cad_ops}, device="cpu", **sizes)
        pc, pcv = pred._cloud_from_depth(*args)
        ref_pc, ref_pcv = jp._jit_cloud(*jargs)
        np.testing.assert_array_equal(pc[0].numpy(), np.asarray(ref_pc))
        np.testing.assert_array_equal(pcv[0].numpy(), np.asarray(ref_pcv))
        # the cloud is the exact chain's only where the rule falls back
        pts, valid = geometry.backproject_depth(*args, max_points=4096)
        keep = geometry.statistical_outlier_mask(pts, valid)
        idx, sel = sampling.farthest_point_sample(pts, keep, max_pc)
        exact = torch.where(sel[..., None], torch.gather(
            pts, 1, idx[..., None].expand(-1, -1, 3)), 0.0)
        assert torch.equal(exact[0], pc[0, :max_pc]) != grouped
    out = pred.predict(depth, K, 1.0, [mask], [seed],
                       uniforms=[np.random.default_rng(0).random(
                           (1, 512, 3))])[0]
    assert np.isfinite(out["R"]).all() and np.isfinite(out["t"]).all()
