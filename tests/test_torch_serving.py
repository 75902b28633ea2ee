"""Serving export (pose6d_tpu_torch/serving.py) on the CPU: the online
frame frozen to one torch.export artifact must (a) round-trip through
save / load and replay the live Predictor.predict bit for bit on the
same RANSAC draws, (b) agree with the JAX package's own artifact
(pose6d_tpu/serving.py) on one frame, (c) load and run in a process that
imports no model, solver or API module, and (d) refuse a cached-mode
Predictor."""
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from scipy.spatial.transform import Rotation

import pose6d_tpu.api as jax_api
import pose6d_tpu.models.attention as jax_attention
import pose6d_tpu_torch.api as torch_api
from pose6d_tpu.api import Predictor as JaxPredictor
from pose6d_tpu.serving import export_predictor as jax_export_predictor
from pose6d_tpu.serving import load_exported as jax_load_exported
from pose6d_tpu_torch import serving
from pose6d_tpu_torch.api import Predictor
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.data.synth import default_intrinsics, rasterize_depth
from pose6d_tpu_torch.models import DPFMConfig, DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.solvers import candidates
from pose6d_tpu_torch.spectral import device_lbo
from pose6d_tpu_torch.spectral.operators import point_cloud_operators

from test_torch_api import CKPT

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)

# the JAX serving test's sizes (tests/test_serving.py)
SIZES = dict(v_cad=640, v_pc=256, max_pc=250, ransac_hypotheses=256,
             icp_iters=3, lobpcg_iters=20)


def render_frame(seed: int):
    """A rasterized random_shape mesh (514 vertices, scaled to 14 cm) at a
    pose drawn from `seed`, as tests/test_torch_online.py renders it:
    (depth uint16 (480, 640), mask, K, the mesh's vertices)."""
    verts, faces = random_shape(seed, nu=16, nv=32)
    verts = verts * (140.0 / np.linalg.norm(verts.max(0) - verts.min(0)))
    rng = np.random.default_rng(seed)
    R_gt = Rotation.from_rotvec(rng.normal(size=3) * 0.9).as_matrix()
    t_gt = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                     rng.uniform(900, 1200)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        depth = rasterize_depth(verts, faces, R_gt, t_gt).astype(np.uint16)
    return depth, depth > 0, default_intrinsics(), verts


def frame_inputs(depth, mask, K, depth_scale=1.0):
    """The artifact's inputs: depth (H, W) f32, K (3, 3) f32, cam_scale ()
    f32, mask (H, W) bool."""
    return (torch.as_tensor(depth.astype(np.float32)),
            torch.as_tensor(np.asarray(K, np.float32)),
            torch.tensor(1000.0 / depth_scale, dtype=torch.float32),
            torch.as_tensor(mask))


@pytest.fixture(scope="module")
def exported():
    """A random-weight k_eig = 32 DPFMNet (torch seed 0) serving a
    random_shape CAD at the JAX serving test's sizes (4096 backprojected
    points), its artifact and one frame."""
    depth, mask, K, verts = render_frame(5)
    torch.manual_seed(0)
    cad_ops = point_cloud_operators(verts * 0.1, k_eig=32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_api, "MAX_RAW", 4096)
        pred = Predictor(DPFMNet(DPFMConfig(k_eig=32)), {3: cad_ops},
                         device="cpu", **SIZES)
        blob = serving.export_predictor(pred, 3, depth.shape)
        u = serving.ransac_uniforms(SIZES["ransac_hypotheses"], seed=0,
                                    device="cpu")
        live = pred.predict(depth, K, 1.0, [mask], [3], uniforms=[u])[0]
    return {"pred": pred, "cad_ops": cad_ops, "blob": blob, "uniforms": u,
            "live": live,
            "inputs": frame_inputs(depth, mask, K)}


def test_roundtrip_matches_live_predictor(exported):
    """The artifact against the live request on the same draws: every
    output bit for bit, and a proper rotation."""
    assert len(exported["blob"]) > 10_000
    fn = serving.load_exported(exported["blob"], device="cpu")
    out = fn(*exported["inputs"], exported["uniforms"])
    live = exported["live"]
    assert set(out) == set(serving.OUTPUTS)
    for k in serving.OUTPUTS:
        got = out[k].numpy()
        assert got.dtype == live[k].dtype and got.shape == live[k].shape, k
        np.testing.assert_array_equal(got, live[k], err_msg=k)
    assert abs(float(np.linalg.det(out["R"].double().numpy())) - 1) < 1e-3


def test_load_exported_defaults_to_the_card(monkeypatch):
    """load_exported runs on the card unless the CPU is asked for: where
    CUDA is missing the default refuses, before the blob is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_exported(b"")


def test_artifact_runs_without_model_code(exported, tmp_path):
    """A fresh process that imports torch and serving.load_exported (the
    op registrations) loads and runs the artifact: the same bits, and no
    model, solver, API or spectral module of the port, and no JAX."""
    (tmp_path / "frame.pt2").write_bytes(exported["blob"])
    torch.save({"inputs": exported["inputs"], "u": exported["uniforms"]},
               tmp_path / "inputs.pt")
    code = (
        "import sys, torch\n"
        "from pose6d_tpu_torch.serving import load_exported\n"
        "d = torch.load(sys.argv[1] + '/inputs.pt')\n"
        "fn = load_exported(open(sys.argv[1] + '/frame.pt2', 'rb').read(),\n"
        "                   device='cpu')\n"
        "torch.save(fn(*d['inputs'], d['u']), sys.argv[1] + '/out.pt')\n"
        "print(' '.join(sorted(m for m in sys.modules\n"
        "                      if m.startswith(('pose6d_tpu', 'jax')))))\n")
    # the thread count of this module's CPU runs, whose sums it orders
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = res.stdout.split()
    assert "pose6d_tpu_torch.ops.kernels" in mods
    bad = [m for m in mods if m.split(".")[0] != "pose6d_tpu_torch"
           or m.split(".")[1:2] in (["models"], ["api"], ["solvers"],
                                    ["spectral"], ["train"], ["data"])]
    assert not bad, bad
    out = torch.load(tmp_path / "out.pt")
    for k in serving.OUTPUTS:
        np.testing.assert_array_equal(out[k].numpy(), exported["live"][k],
                                      err_msg=k)


def test_cached_mode_refused(exported):
    cached = Predictor(exported["pred"].model, {3: exported["cad_ops"]},
                       mode="cached", device="cpu", v_cad=640)
    with pytest.raises(ValueError, match="cached mode"):
        serving.export_predictor(cached, 3, (64, 64))


def test_draws_match_the_ransac_blocks():
    assert serving.HYP_BLOCK == candidates.HYP_BLOCK
    assert serving.draw_shape(131072) == (256, 512, 3)
    assert serving.draw_shape(256) == (1, 256, 3)
    u = serving.ransac_uniforms(1000, seed=3, device="cpu")
    assert u.shape == (2, 512, 3) and u.dtype == torch.float32
    assert torch.equal(u, serving.ransac_uniforms(1000, seed=3,
                                                  device="cpu"))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


def _angle_deg(Ra, Rb):
    """The angle between two rotations from |Ra - Rb|_F = sqrt(8)
    sin(angle / 2), in float64 (exact near 0)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, d / np.sqrt(8.0)))))


def test_artifact_matches_jax_artifact(monkeypatch):
    """The frame of tests/test_torch_online.py::
    test_predictor_online_matches_jax_predictor (seed 12, synth_seen
    weights, CAD 640, PC 512 with 500 sampled, 4096 backprojected points,
    30 LOBPCG iterations, 512 hypotheses, 5 ICP iterations) through the
    JAX package's export_predictor artifact (its attention's bf16 casts
    patched to f32, as that test does) and the port's, the port's on the
    draws that JAX's key yields block by block and with JAX's LOBPCG start
    block. The tolerance is that test's: rotation within 1 deg,
    translation within 1 % of the diameter, the same inlier count; the
    same flip hypothesis as JAX's live predict on the same key (JAX's
    artifact does not return it)."""
    seed = 12
    depth, mask, K, verts = render_frame(seed)
    cad_ops = point_cloud_operators(verts * 0.1)
    diam = float(np.linalg.norm(cad_ops["xyz"].max(0)
                                - cad_ops["xyz"].min(0)))
    sizes = dict(v_cad=640, v_pc=512, max_pc=500, ransac_hypotheses=512,
                 icp_iters=5, lobpcg_iters=30)
    monkeypatch.setattr(jax_api, "MAX_RAW", 4096)
    monkeypatch.setattr(torch_api, "MAX_RAW", 4096)
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)
    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    jp = JaxPredictor(params, {seed: cad_ops}, mode="online", **sizes)
    # the key JAX's predict(seed=0) hands its first instance
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    ref_live = jp.predict(depth, K, 1.0, [mask], [seed], seed=0)[0]
    ref = jax_load_exported(jax_export_predictor(jp, seed, depth.shape))(
        jnp.asarray(depth, jnp.float32), jnp.asarray(K, jnp.float32),
        jnp.float32(1000.0), jnp.asarray(mask), key)

    # ransac_pose splits the key once per block (one block of 512 here)
    _, sub = jax.random.split(key)
    draws = np.array(jax.random.uniform(sub, (512, 3)))[None]
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (512, 64)))
    monkeypatch.setattr(device_lbo, "default_x0",
                        lambda v, k, device: torch.as_tensor(x0).to(device))
    pred = Predictor(load_flax_checkpoint(CKPT, DPFMNet()), {seed: cad_ops},
                     device="cpu", **sizes)
    fn = serving.load_exported(serving.export_predictor(pred, seed,
                                                        depth.shape),
                               device="cpu")
    out = fn(*frame_inputs(depth, mask, K), torch.as_tensor(draws))

    assert _angle_deg(out["R"].numpy(), ref["R"]) < 1.0
    assert np.linalg.norm(out["t"].numpy() - np.asarray(ref["t"])) \
        < 0.01 * diam
    assert int(out["n_inliers"]) == int(ref["n_inliers"])
    assert int(out["flip_hypothesis"]) == int(ref_live["flip_hypothesis"])
