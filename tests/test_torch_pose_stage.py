"""The port's pose stage on the CPU against the JAX package's on the same
result files, both packages' padding cut to 512 (in this test only):
the txt fields in the reference's order, avg_results.txt, ply point
counts, a remainder chunk and a file without correspondences. Also the
port's stage on JAX's result files (GNC) and the pose CLI."""
import re
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import pose6d_tpu.train.pose_stage as jax_pose_stage
from pose6d_tpu.config import Config as JaxConfig
from pose6d_tpu.train.eval_loop import evaluate as jax_evaluate
from pose6d_tpu_torch.cli import pose as pose_cli
from pose6d_tpu_torch.config import Config
from pose6d_tpu_torch.data.ply import read_ply
from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.train import eval_loop
from pose6d_tpu_torch.train import pose_stage

from test_torch_api import CKPT
from test_torch_eval import PADS, f32_attention, lm_dataset

torch.set_num_threads(2)

PAD = 512
HYPS = 1024
ICP_ITERS = 10
FIELDS = ("Object ID", "Inlier ration of P_pred", "Num. of correspondences",
          "Avg. Euclidean Distance (ADD) [cm]", "Add Score thres",
          "Add Score thres (xyz direction)", "Add-S Score",
          "Avg. Euclidean Distance (ADD) ICP", "Add Score ICP thres",
          "Add Score ICP thres (xyz direction)", "Add-S Score ICP",
          "Error [cm]", "Error [deg]")
MATRICES = ("T_gt (Ground Truth Transformation)",
            "T_pred (Predicted Transformation)",
            "T_pred_ICP (Predicted Transformation from ICP)")


@pytest.fixture
def small_pads(monkeypatch):
    for mod in (jax_pose_stage, pose_stage):
        monkeypatch.setattr(mod, "PAIR_PAD", PAD)
        monkeypatch.setattr(mod, "PT_PAD", PAD)


def port_results(tmp_path):
    """The port's evaluate on the two LM frames at test size (with the
    LM intrinsics; obj 5's map keeps no pair at this size, so file 0 is
    the one without correspondences), then two copies of file 1 (obj 11),
    one under obj 3: four files, three instances. The three get
    well-determined correspondences in place of the test-size map's: the
    observed cloud becomes 200 GT-posed CAD points (0.005 cm noise) and
    p_pred their pairs plus 30 % to 50 % wrong ones. On the predicted
    pairs, which RANSAC's 0.05 cm threshold hardly ever accepts, its
    inlier set, and with it the pose, moves with f32 rounding."""
    cfg = Config()
    cfg.pad_v_cad, cfg.pad_v_pc = PADS["v_cad"], PADS["v_pc"]
    cfg.eval.batch_size = 2
    d = tmp_path / "results"
    eval_loop.evaluate(cfg, load_flax_checkpoint(CKPT, DPFMNet()),
                       dataset=lm_dataset(with_K=True), save_dir=d,
                       device="cpu")
    assert len(np.load(d / "result_000000.npz")["p_pred"]) == 0
    r = dict(np.load(d / "result_000001.npz"))
    rng = np.random.default_rng(0)
    cad = r["cad_xyz"]
    for i, (obj, n_gt, n_bad) in enumerate(((11, 140, 60), (3, 120, 80),
                                            (11, 80, 80)), start=1):
        sel = rng.permutation(len(cad))[:200]
        pc = (cad[sel] @ r["R_m2c"].T + r["t_m2c"]
              + rng.normal(size=(200, 3)) * 0.005).astype(np.float32)
        gt = np.stack([sel, np.arange(200)], 1)[rng.permutation(200)[:n_gt]]
        bad = np.stack([rng.integers(0, len(cad), n_bad),
                        rng.integers(0, 200, n_bad)], 1)
        pairs = np.concatenate([gt, bad])
        np.savez(d / f"result_{i:06d}.npz",
                 **{**r, "obj_id": obj, "pcd_depth": pc,
                    "align_pc": ((pc - r["t_m2c"]) @ r["R_m2c"]
                                 ).astype(np.float32),
                    "p_pred": pairs[rng.permutation(len(pairs))
                                    ].astype(np.int32)})
    return d


def jax_ransac_draws(seed, n_files, hyps=HYPS):
    """run_pose_stage's per-file keys (one split per file, in order) and
    ransac_pose's one split per 1024-block."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_files):
        key, sub = jax.random.split(key)
        blocks = []
        for _ in range(-(-hyps // 1024)):
            sub, s2 = jax.random.split(sub)
            blocks.append(np.asarray(jax.random.uniform(s2, (1024, 3))))
        out.append(np.stack(blocks))
    return out


def parse_txt(path):
    """{field: float} and {matrix name: (4, 4)} of one result txt, plus
    its field names in order."""
    text = path.read_text()
    names, fields = [], {}
    for line in text.splitlines():
        m = re.match(r"^([^\[\]:]+(?:\[[^\]]*\])?): (\S+)$", line)
        if m:
            names.append(m.group(1))
            fields[m.group(1)] = float(m.group(2))
    mats = {}
    for name in MATRICES:
        block = text.split(name + ":\n", 1)[1].split("]]", 1)[0]
        mats[name] = np.array(block.replace("[", " ").replace("]", " ").split(),
                              float).reshape(4, 4)
    return names, fields, mats


def test_pose_stage_matches_jax(tmp_path, small_pads):
    """RANSAC (1024 hypotheses, JAX's draws) -> depth-render flip
    disambiguation -> ICP against the GT-posed CAD (10 iterations),
    batch 2 over three instances (a full and a remainder chunk). The same
    txt files with the reference's fields in order; the 0/1 scores and
    flip hypotheses equal; distances, errors and matrices within 1e-4
    (ADD) / 1e-3 deg / 1e-4 absolute (ICP in f32, sums in another order);
    avg_results.txt within 1e-5; the same ply point counts."""
    d = port_results(tmp_path)
    kw = dict(solver="ransac", ransac_hypotheses=HYPS,
              icp_max_iter=ICP_ITERS, disambiguate=True, batch=2)
    jax_pose_stage.run_pose_stage(d, tmp_path / "jax", **kw)
    pose_stage.run_pose_stage(d, tmp_path / "port", device="cpu",
                              uniforms=jax_ransac_draws(0, 4), **kw)
    ja = tmp_path / "jax" / "results_poses_RANSAC"
    pa = tmp_path / "port" / "results_poses_RANSAC"
    txts = sorted(p.name for p in (ja / "results").iterdir())
    assert txts == sorted(p.name for p in (pa / "results").iterdir())
    assert txts == ["obj_11_result_1.txt", "obj_11_result_3.txt",
                    "obj_3_result_2.txt"]
    for name in txts:
        jn, jf, jm = parse_txt(ja / "results" / name)
        pn, pf, pm = parse_txt(pa / "results" / name)
        assert pn == jn and tuple(jn[:len(FIELDS)]) == FIELDS
        assert "Flip hypothesis" in jn
        for k, v in jf.items():
            if "Score" in k or k in ("Object ID", "Num. of correspondences",
                                     "Flip hypothesis"):
                assert pf[k] == v, (name, k, pf[k], v)
            elif "[deg]" in k:
                assert abs(pf[k] - v) < 1e-3, (name, k, pf[k], v)
            else:
                assert abs(pf[k] - v) <= 1e-4 * max(1.0, abs(v)), \
                    (name, k, pf[k], v)
        for k in MATRICES:
            np.testing.assert_allclose(pm[k], jm[k], atol=1e-4)
        stem = name[:-4]
        i = stem.rsplit("_", 1)[1]
        for f in (f"cad_{i}.ply", f"cad_{i}_pose_est.ply",
                  f"cad_{i}_pose_gt.ply", f"pc_{i}.ply"):
            assert (len(read_ply(pa / "ply" / stem / f)["verts"])
                    == len(read_ply(ja / "ply" / stem / f)["verts"]))
    ja_avg = (ja / "avg_results.txt").read_text().splitlines()
    pa_avg = (pa / "avg_results.txt").read_text().splitlines()
    assert len(ja_avg) == len(pa_avg) == 60
    for a, b in zip(ja_avg, pa_avg):
        ka, va = a.rsplit(": ", 1)
        kb, vb = b.rsplit(": ", 1)
        assert ka == kb and abs(float(va) - float(vb)) < 1e-5


def test_pose_stage_reads_jax_results(monkeypatch, tmp_path, small_pads):
    """JAX's evaluate writes the result files; the port's pose stage reads
    them with GNC-TLS (4096-triad search) and ICP against the observed
    cloud: the reference's txt fields, finite errors (file 0, obj 5,
    has no pair at this size and is skipped), and instance_uniforms'
    draws by default."""
    f32_attention(monkeypatch)
    jcfg = JaxConfig()
    jcfg.pad_v_cad, jcfg.pad_v_pc = PADS["v_cad"], PADS["v_pc"]
    jcfg.eval.batch_size = 2
    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    d = tmp_path / "jax_results"
    jax_evaluate(jcfg, params, dataset=lm_dataset(with_K=True), save_dir=d)
    chunks = []
    acc = pose_stage.run_pose_stage(d, tmp_path / "out", solver="gnc",
                                    icp_target="pc", icp_max_iter=ICP_ITERS,
                                    write_ply=False, device="cpu",
                                    chunks=chunks)
    base = tmp_path / "out" / "results_poses_GNC"
    assert not (base / "ply").exists()
    names = sorted(p.name for p in (base / "results").iterdir())
    assert names == ["obj_11_result_1.txt"]
    for name in names:
        fnames, fields, mats = parse_txt(base / "results" / name)
        assert tuple(fnames[:len(FIELDS)]) == FIELDS
        assert np.isfinite(list(fields.values())).all()
    assert len(acc["obj_5_add"]) == 0 and len(acc["obj_11_add"]) == 1
    assert chunks[0]["i"] == [1]
    assert np.isfinite(chunks[0]["T_icp"]).all()


def test_pose_cli_matches_run_pose_stage(tmp_path, small_pads):
    """python -m pose6d_tpu_torch.cli.pose ransac ... --device cpu
    --no-ply: the same avg_results.txt as run_pose_stage with the same
    arguments and seed."""
    d = port_results(tmp_path)
    pose_stage.run_pose_stage(d, tmp_path / "lib", ransac_hypotheses=HYPS,
                              write_ply=False, device="cpu")
    pose_cli.main(["ransac", str(d), str(tmp_path / "cli"), "--device", "cpu",
                   "--no-ply", "--hypotheses", str(HYPS)])
    a = (tmp_path / "lib" / "results_poses_RANSAC" / "avg_results.txt")
    b = (tmp_path / "cli" / "results_poses_RANSAC" / "avg_results.txt")
    assert a.read_text() == b.read_text()
    assert not (tmp_path / "cli" / "results_poses_RANSAC" / "ply").exists()
    shutil.rmtree(tmp_path / "cli")
