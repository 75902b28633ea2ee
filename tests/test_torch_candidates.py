"""The port's candidate select (the base path, rotation TTA and ZoomOut)
and ICP's fine_iters on the CPU against the JAX package on the same
inputs."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from scipy.spatial.transform import Rotation

import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.models import DPFMConfig
from pose6d_tpu.models import DPFMNet as JaxDPFMNet
from pose6d_tpu.ops.masking import pad_to
from pose6d_tpu.solvers import icp as jax_icp
from pose6d_tpu.solvers.candidates import \
    candidate_select_pose as jax_candidate_select_pose
from pose6d_tpu_torch.api import pad_operators
from pose6d_tpu_torch.data.ply import read_ply
from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.solvers import icp
from pose6d_tpu_torch.solvers.candidates import candidate_select_pose
from pose6d_tpu_torch.spectral.operators import point_cloud_operators
from pose6d_tpu_torch.train.pose_stage import _splat_observed

from test_multistart import K as K_JAX
from test_multistart import l_shape
from test_torch_api import CKPT, FRAME
from test_torch_online import _angle_deg

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_icp_bank_fine_iters_matches_jax():
    """ICP at coarse stride 4 with the flip bank's single full-resolution
    step (fine_iters=1; the default 5 is tests/test_torch_solvers.py's
    case) against JAX's: rotation within 1e-3 deg, translation 1e-3 cm,
    rmse 1e-4 relative (f32 sums in another order)."""
    pts = l_shape()
    rng = np.random.default_rng(1)
    cad = pad_to(pts, 1024)
    valid = np.arange(1024) < len(pts)
    R_gt = Rotation.from_rotvec([0.1, -0.2, 0.15]).as_matrix()
    pc = pad_to((pts[rng.permutation(len(pts))[:400]] @ R_gt.T
                 + [1.0, 0.0, 50.0]).astype(np.float32), 512)
    pcv = np.arange(512) < 400
    R0 = Rotation.from_rotvec([0.15, -0.1, 0.1]).as_matrix().astype(
        np.float32)
    t0 = np.asarray([1.5, 0.3, 50.5], np.float32)
    ref = jax_icp.icp_cloud_to_model(
        jnp.asarray(cad), jnp.asarray(valid), jnp.asarray(pc),
        jnp.asarray(pcv), jnp.asarray(R0), jnp.asarray(t0),
        max_corr_dist=2.0, max_iter=6, coarse_stride=4,
        fine_iters=1)
    out = icp.icp_cloud_to_model(_t(cad)[None], _t(valid)[None],
                                 _t(pc)[None], _t(pcv)[None], _t(R0)[None],
                                 _t(t0)[None], max_corr_dist=2.0,
                                 max_iter=6, coarse_stride=4,
                                 fine_iters=1)
    assert _angle_deg(out["R"][0].numpy(), np.asarray(ref["R"])) < 1e-3
    np.testing.assert_allclose(out["t"][0].numpy(), np.asarray(ref["t"]),
                               atol=1e-3)
    np.testing.assert_allclose(float(out["rmse"][0]), float(ref["rmse"]),
                               rtol=1e-4)


def _frame():
    """LM obj 11 (CAD cut to 2000 points and padded to 2048, all 622
    observed points padded to 640): operators and padded tensors."""
    cad_xyz = read_ply(FRAME / "cad_0.ply")["verts"]
    pc_xyz = read_ply(FRAME / "pc_0.ply")["verts"]
    sel = np.random.default_rng(0).permutation(len(cad_xyz))[:2000]
    cad_ops = point_cloud_operators(cad_xyz[sel])
    pc_ops = point_cloud_operators(pc_xyz)
    return {"cad": pad_operators(cad_ops, 2048, "cpu"),
            "pc": pad_operators(pc_ops, 640, "cpu"),
            "pc_xyz": pc_ops["xyz"],
            "diam": float(np.linalg.norm(cad_ops["xyz"].max(0)
                                         - cad_ops["xyz"].min(0)))}


def _f32_attention(monkeypatch):
    """JAX's XLA attention with its bf16 casts turned into f32 (as
    tests/test_torch_model.py does), in this test only."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)


def _params():
    return {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}


def _ransac_draws(key, n_hypotheses):
    """ransac_pose's draws at hyp_block 512: one split per block."""
    draws = []
    for _ in range(n_hypotheses // 512):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.uniform(sub, (512, 3))))
    return np.stack(draws)


def test_candidate_select_pose_base_matches_jax(monkeypatch):
    """The base path on LM obj 11 (CAD cut to 2000 points, all 622
    observed; tests/test_torch_api.py's frame), synth_seen weights,
    4096 hypotheses with JAX's draws, 30 ICP iterations at coarse stride
    4. With JAX's attention in f32 (tests/test_torch_model.py) both
    compute the same function: pose within 0.1 deg and 1e-3 of the
    diameter (f32 sums in another order through RANSAC's refits and 30
    ICP steps; measured 0.057 deg), the same inlier count, candidate 0."""
    frame = _frame()
    diam = frame["diam"]
    _f32_attention(monkeypatch)
    params = _params()
    jmodel = JaxDPFMNet(DPFMConfig())
    cad = {k: jnp.asarray(v.numpy()) for k, v in frame["cad"].items()}
    pc = {k: jnp.asarray(v.numpy()) for k, v in frame["pc"].items()}
    key = jax.random.PRNGKey(3)
    obs = jnp.zeros((48, 64))
    ref = jax.jit(lambda c, q: jax_candidate_select_pose(
        lambda c2, q2: jmodel.apply(params, c2, q2), c, q, jnp.float32(diam),
        key, K_JAX, obs, obs > 0, n_fmap=30, ransac_hypotheses=4096,
        icp_iters=30))(cad, pc)
    draws = [_ransac_draws(key, 4096)]
    model = load_flax_checkpoint(CKPT, DPFMNet())
    out = candidate_select_pose(
        model, {k: _t(v)[None] for k, v in cad.items()},
        {k: _t(v)[None] for k, v in pc.items()}, torch.tensor([diam]),
        n_fmap=30, ransac_hypotheses=4096, icp_iters=30,
        uniforms=_t(draws[0])[None])
    assert _angle_deg(out["R"][0].numpy(), np.asarray(ref["R"])) < 0.1
    assert np.linalg.norm(out["t"][0].numpy() - np.asarray(ref["t"])) \
        < 1e-3 * diam
    assert int(out["n_inliers"][0]) == int(ref["n_inliers"])
    assert int(out["candidate"][0]) == int(ref["candidate"]) == 0


@pytest.mark.parametrize("option", [{"tta_rotations": 3},
                                    {"zoomout_k": 64}])
def test_candidate_select_pose_candidates_match_jax(monkeypatch, option):
    """Rotation TTA (the base map and two rotated clouds) and ZoomOut (the
    base map and its gated upsampling to 64) on the frame above, with its
    observed depth splatted through the LM intrinsics as evidence,
    select_trigger = 1 so that every candidate competes, and
    select_margin = -0.8, a bonus that lets an alternative win here (the
    base map scores 4.3, the alternatives 10.3 and 17.2 on this frame):
    the same winning candidate as JAX (not the base; JAX's attention in
    f32, its draws). For TTA also its pose within 0.1 deg and 1e-3 of the
    diameter and the same inlier count. The ZoomOut refit is
    ill-conditioned on this frame in both packages (its normal equations
    see few distinct CAD rows: JAX's own 64 x 64 map reaches |C| = 373,
    against ~1 for the predicted map), so its pose is not compared here;
    tests/test_torch_zoomout.py holds the refit on a well-posed pair."""
    frame = _frame()
    diam = frame["diam"]
    _f32_attention(monkeypatch)
    jmodel, params = JaxDPFMNet(DPFMConfig()), _params()
    cad = {k: jnp.asarray(v.numpy()) for k, v in frame["cad"].items()}
    pc = {k: jnp.asarray(v.numpy()) for k, v in frame["pc"].items()}
    key = jax.random.PRNGKey(3)
    obs, mask = _splat_observed(frame["pc_xyz"], np.asarray(K_JAX), 480, 640)
    kw = dict(n_fmap=30, ransac_hypotheses=1024, icp_iters=10,
              select_trigger=1.0, select_margin=-0.8, **option)
    ref = jax.jit(lambda c, q: jax_candidate_select_pose(
        lambda c2, q2: jmodel.apply(params, c2, q2), c, q, jnp.float32(diam),
        key, K_JAX, jnp.asarray(obs), jnp.asarray(mask), **kw))(cad, pc)
    model = load_flax_checkpoint(CKPT, DPFMNet())
    out = candidate_select_pose(
        model, {k: v[None] for k, v in frame["cad"].items()},
        {k: v[None] for k, v in frame["pc"].items()}, torch.tensor([diam]),
        K=_t(K_JAX)[None], obs_z=_t(obs)[None], mask=_t(mask)[None],
        uniforms=_t(_ransac_draws(key, 1024))[None], **kw)
    assert int(out["candidate"][0]) == int(ref["candidate"]) > 0
    if "zoomout_k" in option:
        return
    assert _angle_deg(out["R"][0].numpy(), np.asarray(ref["R"])) < 0.1
    assert np.linalg.norm(out["t"][0].numpy() - np.asarray(ref["t"])) \
        < 1e-3 * diam
    assert int(out["n_inliers"][0]) == int(ref["n_inliers"])
