"""The port's evaluate() on the CPU against the JAX package's on the same
two-instance dataset: inlier ratios, the result npz layout, p_pred, and
the candidate selection of rotation TTA and ZoomOut."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.config import Config as JaxConfig
from pose6d_tpu.train.eval_loop import evaluate as jax_evaluate
from pose6d_tpu_torch.config import Config
from pose6d_tpu_torch.data.dataset import gt_object
from pose6d_tpu_torch.data.ply import read_ply
from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.solvers.kabsch import kabsch_umeyama
from pose6d_tpu_torch.spectral.operators import point_cloud_operators
from pose6d_tpu_torch.train import eval_loop

from test_torch_api import CKPT, ROOT

torch.set_num_threads(2)

PLY = ROOT / "results_synth_unseen" / "step5737" / "results_poses_RANSAC" \
    / "ply"
LM_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                 [0.0, 0.0, 1.0]], np.float32)
PADS = {"v_cad": 512, "v_pc": 256}


def lm_dataset(with_K: bool):
    """The two committed LM frames (obj 5 and obj 11) cut to test size:
    480 CAD points and 240 observed points each, point-cloud operators,
    GT pose from the committed posed CAD, GT pairs at 0.05 diam; with_K
    adds the LM intrinsics and the 480 x 640 image size."""
    items = []
    for obj, folder, i in ((5, "obj_5_result_1", 1),
                           (11, "obj_11_result_0", 0)):
        d = PLY / folder
        cad = read_ply(d / f"cad_{i}.ply")["verts"]
        gt = read_ply(d / f"cad_{i}_pose_gt.ply")["verts"]
        pc = read_ply(d / f"pc_{i}.ply")["verts"]
        R, t = kabsch_umeyama(torch.tensor(cad, dtype=torch.float32)[None],
                              torch.tensor(gt, dtype=torch.float32)[None],
                              torch.ones(1, len(cad)))
        rng = np.random.default_rng(obj)
        cad = cad[rng.permutation(len(cad))[:480]]
        pc = pc[rng.permutation(len(pc))[:240]]
        cad_ops = point_cloud_operators(cad)
        pc_ops = point_cloud_operators(pc)
        diam = float(np.linalg.norm(cad.max(0) - cad.min(0)))
        kw = {"K": LM_K, "im_hw": (480, 640)} if with_K else {}
        obj_d = gt_object(cad_ops["xyz"], pc_ops["xyz"], R[0].numpy(),
                          t[0].numpy(), diam, obj, **kw)
        items.append((cad_ops, pc_ops, obj_d))
    return items


def f32_attention(monkeypatch):
    """JAX's XLA attention with its bf16 casts turned into f32 (as
    tests/test_torch_model.py does), in the calling test only."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)


def jax_select_draws(idx, bsz, hyps):
    """JAX's candidate-scorer draws: ransac_pose under
    split(fold_in(PRNGKey(7), idx), B), one split per 1024-block."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), idx),
                            bsz)
    out = []
    for k in keys:
        blocks = []
        for _ in range(-(-hyps // 1024)):
            k, sub = jax.random.split(k)
            blocks.append(np.asarray(jax.random.uniform(sub, (1024, 3))))
        out.append(np.stack(blocks))
    return np.stack(out)


def configs(**ev):
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.pad_v_cad, c.pad_v_pc = PADS["v_cad"], PADS["v_pc"]
        c.eval.batch_size = 2
        for k, v in ev.items():
            setattr(c.eval, k, v)
    return jcfg, cfg


def run_both(monkeypatch, tmp_path, items, **ev):
    f32_attention(monkeypatch)
    jcfg, cfg = configs(**ev)
    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    ref = jax_evaluate(jcfg, params, dataset=items,
                       save_dir=tmp_path / "jax")
    selection = []
    out = eval_loop.evaluate(cfg, load_flax_checkpoint(CKPT, DPFMNet()),
                             dataset=items, save_dir=tmp_path / "port",
                             device="cpu", select_draws=jax_select_draws,
                             selection=selection)
    return ref, out, [s["winner"] for s in selection]


def assert_same_results(tmp_path, n: int):
    """Same files; per file the same keys, dtypes and shapes; p_pred
    equal; ir within 1e-6; the arrays copied from the sample equal; the
    model outputs within 1e-3 (JAX's f32 forward sums in another
    order)."""
    names = sorted(p.name for p in (tmp_path / "jax").glob("result_*.npz"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    assert len(names) == n
    for name in names:
        a = dict(np.load(tmp_path / "jax" / name))
        b = dict(np.load(tmp_path / "port" / name))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
            assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(b["p_pred"], a["p_pred"])
        assert abs(float(b["ir"]) - float(a["ir"])) < 1e-6
        for k in ("cad_xyz", "pcd_depth", "align_pc", "R_m2c", "t_m2c",
                  "diam_cad", "obj_id", "K", "im_hw", "evecs_cad",
                  "evecs_pc"):
            np.testing.assert_array_equal(b[k], a[k])
        for k in ("C_pred", "overlap12", "overlap21"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-3)


def test_evaluate_matches_jax(monkeypatch, tmp_path, capsys):
    """Reference settings (no candidates), batch 2 over the two frames:
    the same overall and per-object IR (1e-6) and printed lines, and the
    same npz files."""
    items = lm_dataset(with_K=False)
    ref, out, winners = run_both(monkeypatch, tmp_path, items)
    assert abs(out[0] - ref[0]) < 1e-6
    assert sorted(out[1]) == sorted(ref[1]) == [5, 11]
    for k in ref[1]:
        assert abs(out[1][k] - ref[1][k]) < 1e-6
    lines = capsys.readouterr().out.splitlines()
    ir_lines = [ln for ln in lines if "IR:" in ln]
    assert ir_lines[:3] == ir_lines[3:]
    assert winners == [0, 0]
    assert_same_results(tmp_path, 2)


@pytest.mark.parametrize("with_K,ev,won", [
    (True, {"tta_rotations": 4}, [1, 3]),
    (False, {"tta_rotations": 2, "zoomout_k": 64, "zoomout_gate_tau": 0.15},
     [2, 2])])
def test_evaluate_candidates_match_jax(monkeypatch, tmp_path, with_K, ev,
                                       won):
    """Candidates with select_trigger = 1, so that every frame's
    candidates compete. With the LM intrinsics the depth score decides
    (JAX's scorer draws handed in) among the base map and three rotated
    clouds; without them the survivor counts decide among the base map,
    its ZoomOut upsampling (gated at 0.15) and the same for one rotated
    cloud. The same winners (these frames' winners below), IR and npz.
    At this test size ZoomOut's refit is ill-conditioned (240 observed
    points, few distinct matches; see tests/test_torch_candidates.py), so
    its depth-scored pose is left out here."""
    items = lm_dataset(with_K=with_K)
    ref, out, winners = run_both(monkeypatch, tmp_path, items,
                                 select_trigger=1.0, **ev)
    assert abs(out[0] - ref[0]) < 1e-6
    for k in ref[1]:
        assert abs(out[1][k] - ref[1][k]) < 1e-6
    assert_same_results(tmp_path, 2)
    assert winners == won
