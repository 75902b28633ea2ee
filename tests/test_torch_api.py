"""The port's cached-mode Predictor against the JAX Predictor on a real
committed frame, and the package's hygiene: no JAX import, CUDA by
default, no kernel build on a host without CUDA, unported options
refused. The online predict() is held to JAX in test_torch_online.py."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pose6d_tpu.api import Predictor as JaxPredictor
from pose6d_tpu_torch.api import Predictor
from pose6d_tpu_torch.data.ply import read_ply
from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.ops.kernels import _build
from pose6d_tpu_torch.solvers.kabsch import kabsch_umeyama
from pose6d_tpu_torch.spectral.operators import point_cloud_operators

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "weights" / "synth_seen.msgpack"
FRAME = (ROOT / "results_synth_unseen" / "step5737" / "results_poses_RANSAC"
         / "ply" / "obj_11_result_0")


def _frob_deg(Ra, Rb):
    """The angle between two rotations from |Ra - Rb|_F, in float64."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, d / np.sqrt(8.0)))))


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_predictor_matches_jax_predictor():
    """LM obj 11 (CAD cut to 2000 of its 5002 points, all 622 observed
    points), point-cloud operators for both, synth_seen weights, the
    same RANSAC draws on both sides."""
    cad = read_ply(FRAME / "cad_0.ply")["verts"]
    gt = read_ply(FRAME / "cad_0_pose_gt.ply")["verts"]
    pc = read_ply(FRAME / "pc_0.ply")["verts"]
    R_gt, t_gt = (x[0].numpy() for x in kabsch_umeyama(
        torch.tensor(cad, dtype=torch.float32)[None],
        torch.tensor(gt, dtype=torch.float32)[None], torch.ones(1, len(cad))))
    sel = np.random.default_rng(0).permutation(len(cad))[:2000]
    cad_ops = point_cloud_operators(cad[sel])
    pc_ops = point_cloud_operators(pc)
    diam = float(np.linalg.norm(cad_ops["xyz"].max(0)
                                - cad_ops["xyz"].min(0)))
    sizes = {"v_cad": 2048, "v_pc": 640}

    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    ref = JaxPredictor(params, {11: cad_ops}, mode="cached", **sizes
                       ).predict_with_operators(11, pc_ops, seed=0)
    # JAX's own answer on this frame (measured 5.2 deg, 0.3 % diam; the
    # committed frames hold none that it recovers within 2 deg at a
    # test-sized CAD)
    assert _rot_deg(ref["R"], R_gt) < 6.0
    assert np.linalg.norm(ref["t"] - t_gt) < 0.01 * diam

    key, draws = jax.random.PRNGKey(0), []
    for _ in range(131072 // 512):       # ransac_pose's draws, per block
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.uniform(sub, (512, 3))))
    model = load_flax_checkpoint(CKPT, DPFMNet())
    out = Predictor(model, {11: cad_ops}, device="cpu", **sizes
                    ).predict_with_operators(11, pc_ops,
                                             uniforms=np.stack(draws))
    # C differs by bf16 rounding in JAX's attention, so the pairs may
    # differ a little; the pose must not (measured 0.14 deg, 3e-4 diam)
    assert _rot_deg(out["R"], ref["R"]) < 1.0
    assert np.linalg.norm(out["t"] - ref["t"]) < 0.01 * diam
    assert out["icp_rmse"] < 0.05 * diam


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pose6d_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pose6d_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pose6d_tpu', 'PIL', 'yaml')]\n"
        "assert not bad, bad\n"
        "online = ['ops.sampling', 'ops.symmetry', 'spectral.lobpcg',\n"
        "          'spectral.device_lbo', 'solvers.verify_pose',\n"
        "          'solvers.multistart', 'solvers.candidates',\n"
        "          'data.shapes', 'data.synth']\n"
        "missing = [m for m in online if 'pose6d_tpu_torch.' + m\n"
        "           not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('pose6d_tpu_')]))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 62    # every submodule imported


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for name in ("jax", "flax", "pose6d_tpu.", "PIL", "yaml"):
        assert f"import {name}" not in src and f"from {name}" not in src


def test_predictor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    model = DPFMNet()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model, {})


@pytest.mark.parametrize("option", [{"fps_groups": 8}])
def test_unported_options_raise(option):
    """Grouped FPS is not ported: the Predictor refuses it, naming the
    ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor(DPFMNet(), {}, device="cpu", **option)


@pytest.mark.parametrize("option", [{"tta_rotations": 2},
                                    {"zoomout_k": 64}])
def test_predictor_candidates_match_jax_predictor(monkeypatch, option):
    """Predictor.predict with rotation TTA or ZoomOut candidates against
    JAX's, on the CPU: tests/test_torch_online.py's rendered random_shape
    frame (seed 12) and test sizes, JAX's attention in f32 and its draws
    on both sides. Pose within 1 deg and 1 % of the diameter, the same
    winning candidate and flip hypothesis."""
    import types
    import warnings

    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    import pose6d_tpu.api as jax_api
    import pose6d_tpu.models.attention as jax_attention
    import pose6d_tpu_torch.api as torch_api
    from pose6d_tpu_torch.data.shapes import random_shape
    from pose6d_tpu_torch.data.synth import default_intrinsics, rasterize_depth
    from pose6d_tpu_torch.spectral import device_lbo
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
    diam = float(np.linalg.norm(cad_ops["xyz"].max(0)
                                - cad_ops["xyz"].min(0)))
    sizes = dict(v_cad=640, v_pc=512, max_pc=500, ransac_hypotheses=512,
                 icp_iters=5, lobpcg_iters=30, **option)
    monkeypatch.setattr(jax_api, "MAX_RAW", 4096)
    monkeypatch.setattr(torch_api, "MAX_RAW", 4096)
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)
    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    ref = JaxPredictor(params, {seed: cad_ops}, mode="online", **sizes
                       ).predict(depth, K, 1.0, [mask], [seed], seed=0)[0]

    key = jax.random.split(jax.random.PRNGKey(0))[1]
    key, sub = jax.random.split(key)
    draws = np.array(jax.random.uniform(sub, (512, 3)))[None]
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (512, 64)))
    monkeypatch.setattr(device_lbo, "default_x0",
                        lambda v, k, device: torch.as_tensor(x0).to(device))
    pred = Predictor(load_flax_checkpoint(CKPT, DPFMNet()), {seed: cad_ops},
                     device="cpu", **sizes)
    out = pred.predict(depth, K, 1.0, [mask], [seed], uniforms=[draws])[0]
    assert _frob_deg(out["R"], ref["R"]) < 1.0
    assert np.linalg.norm(out["t"] - ref["t"]) < 0.01 * diam
    assert int(out["candidate"]) == int(ref["candidate"])
    assert int(out["flip_hypothesis"]) == int(ref["flip_hypothesis"])


def test_cpu_run_never_builds_kernels(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("kernel build reached on a CPU run")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "_start", refuse)
    rng = np.random.default_rng(0)

    def ops(n):
        return {"xyz": (rng.normal(size=(n, 3)) * 3 + 100).astype(np.float32),
                "mass": np.full(n, 0.01, np.float32),
                "evals": np.linspace(0, 5, 64).astype(np.float32),
                "evecs": rng.normal(size=(n, 64)).astype(np.float32) * 0.1}

    before = dict(_build.LAUNCHES)
    out = Predictor(DPFMNet(), {1: ops(120)}, v_cad=128, v_pc=64,
                    ransac_hypotheses=512, icp_iters=3, device="cpu"
                    ).predict_with_operators(1, ops(60))
    assert np.isfinite(out["R"]).all() and np.isfinite(out["t"]).all()
    assert _build.LAUNCHES == before
