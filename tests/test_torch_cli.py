"""The README's command-line workflow through the port's CLIs, in process
on the CPU, on a 1-object, 2-frame dataset that the port writes:
gen_shapes -> synth_data -> generate_cache --serial -> train (2 steps)
-> eval --save-results -> pose ransac -> ir_extraction, with
lm_synth.yaml's model at full width and small pads.

The JAX package's evaluate, reading the port's cache and the port's
params_latest.msgpack, gives the same mean IR (within 1e-6) and the same
result files: the sample's arrays equal, the model outputs within 1e-3
(JAX's f32 forward sums in another order). p_pred is not held: a model
two steps from its init gives weak maps, whose spatial-filter survivors
move with the last bits of C (PERF.md, "weak maps are chaotic"). The
pose stage's pads are cut to 512 in this file, as in
tests/test_torch_pose_stage.py.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

import pose6d_tpu_torch.train.pose_stage as port_pose_stage
from pose6d_tpu.config import load_config as jax_load_config
from pose6d_tpu.train.eval_loop import evaluate as jax_evaluate
from pose6d_tpu_torch.cli import (eval as cli_eval, gen_shapes,
                                  generate_cache, ir_extraction, pose,
                                  synth_data, train as cli_train)

from test_torch_eval import f32_attention

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "config" / "lm_synth.yaml")
PAD = 512


def overrides(base: Path) -> list:
    return [f"data_root={base / 'data'}", f"cache_dir={base / 'cache'}",
            f"logging_dir={base / 'logs'}",
            f"save_results={base / 'results'}", "target_faces=2000",
            "pad_v_cad=1280", "pad_v_pc=1024",
            "train_datasets=[{render_data_name: synth_obj1}]",
            "eval_dataset.render_data_name=synth_obj1",
            "train.batch_size=2", "train.max_steps=2", "train.num_threads=2",
            "eval.batch_size=2"]


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    base = tmp_path_factory.mktemp("workflow")
    ov = overrides(base)
    gen_shapes.main([str(base / "models"), "--count", "1", "--nu", "24",
                     "--nv", "48"])
    synth_data.main([str(base / "data"), "--models", str(base / "models"),
                     "--objects", "1", "--frames", "2", "--z-range", "2800",
                     "3200"])
    assert generate_cache.main(["--config", CONFIG, "--device", "cpu",
                                "--serial", *ov]) == 0
    state = cli_train.main(["--config", CONFIG, "--device", "cpu", *ov])
    weights = next((base / "logs").glob("*/params_latest.msgpack"))
    (ir, per_obj), = cli_eval.main(["--config", CONFIG, "--device", "cpu",
                                    "--weights", str(weights),
                                    "--save-results", *ov])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pose_stage, "PAIR_PAD", PAD)
        mp.setattr(port_pose_stage, "PT_PAD", PAD)
        pose.main(["ransac", str(base / "results"), str(base / "poses"),
                   "--device", "cpu", "--hypotheses", "1024", "--no-ply"])
    per_obj_ir = ir_extraction.main(
        [str(base / "poses" / "results_poses_RANSAC" / "results")])
    return {"base": base, "overrides": ov, "state": state,
            "weights": weights, "ir": ir, "per_obj": per_obj,
            "ir_extraction": per_obj_ir}


def test_workflow_runs_every_stage(workflow):
    base = workflow["base"]
    cache = base / "cache" / "synth_obj1" / "train_pbr"
    for name in ("mapping_list.npz", "scene_list.json", "0_0_obj.npz",
                 "1_0_obj.npz", "0_0_pc_LBO.npz", "1_0_pc_LBO.npz"):
        assert (cache / name).exists(), name
    assert len(list((base / "cache" / "shared_cad").glob(
        "CAD_LBO_*_f2000_k64.npz"))) == 1
    assert workflow["state"].step == 2
    logs = [json.loads(ln) for ln in (workflow["weights"].parent /
                                      "metrics.jsonl").read_text()
            .splitlines()]
    losses = [r["loss"] for r in logs if "loss" in r and "step" in r]
    assert len(losses) >= 2 and np.isfinite(losses).all()
    results = sorted((base / "results").glob("result_*.npz"))
    assert len(results) == 2
    assert list(workflow["per_obj"]) == [1]
    txt = sorted((base / "poses" / "results_poses_RANSAC" / "results")
                 .glob("*.txt"))
    irs = [float(np.load(p)["ir"]) for p in results]
    assert abs(np.mean(irs) - workflow["ir"]) < 1e-6
    # the pose stage writes no txt for an instance without pairs
    with_pairs = [float(np.load(p)["ir"]) for p in results
                  if len(np.load(p)["p_pred"])]
    assert workflow["ir_extraction"] == {1: pytest.approx(with_pairs)}
    assert len(txt) == len(with_pairs)


def test_jax_evaluate_on_port_params_and_cache(workflow, monkeypatch,
                                               tmp_path):
    """JAX's evaluate reads the port's cache and params: the same IR and
    result files as the port's eval CLI."""
    f32_attention(monkeypatch)
    cfg = jax_load_config(CONFIG, workflow["overrides"])
    params = {"params": serialization.msgpack_restore(
        workflow["weights"].read_bytes())["params"]}
    ref_ir, ref_obj = jax_evaluate(cfg, params, save_dir=tmp_path)
    assert abs(ref_ir - workflow["ir"]) < 1e-6
    assert sorted(ref_obj) == sorted(workflow["per_obj"])
    port_dir = workflow["base"] / "results"
    names = sorted(p.name for p in tmp_path.glob("result_*.npz"))
    assert names == sorted(p.name for p in port_dir.glob("result_*.npz"))
    for name in names:
        a, b = dict(np.load(tmp_path / name)), dict(np.load(port_dir / name))
        assert sorted(a) == sorted(b)
        for k in ("cad_xyz", "pcd_depth", "align_pc", "R_m2c", "t_m2c",
                  "K", "im_hw", "evecs_cad", "evecs_pc"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        for k in ("C_pred", "overlap12", "overlap21"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-3, err_msg=k)


def test_parallel_cache_build_equals_serial(workflow, tmp_path):
    """generate_cache with two spawned workers writes the same samples
    as the serial build (the operators' eigenbases aside: ARPACK)."""
    ov = [o for o in workflow["overrides"] if not o.startswith("cache_dir")]
    assert generate_cache.main(["--config", CONFIG, "--device", "cpu",
                                "--workers", "2", f"cache_dir={tmp_path}",
                                *ov]) == 0
    serial = workflow["base"] / "cache" / "synth_obj1" / "train_pbr"
    par = tmp_path / "synth_obj1" / "train_pbr"
    for name in ("mapping_list.npz", "0_0_obj.npz", "1_0_obj.npz"):
        a, b = np.load(serial / name), np.load(par / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("0_0_pc_LBO.npz", "1_0_pc_LBO.npz"):
        a, b = np.load(serial / name), np.load(par / name)
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_allclose(a["evals"], b["evals"], rtol=1e-3,
                                   atol=1e-5)


def test_eval_names_profile_and_rerouted_overrides(workflow, tmp_path):
    """--eval-names with a trailing override (rerouted to the overrides)
    writes <save_results>/<name>/, and --profile a Chrome trace."""
    ov = [o for o in workflow["overrides"]
          if not o.startswith(("save_results", "eval.batch_size"))]
    (ir, _), = cli_eval.main(
        ["--config", CONFIG, "--device", "cpu", "--weights",
         str(workflow["weights"]), "--save-results", "--profile",
         str(tmp_path / "trace"), f"save_results={tmp_path / 'res'}", *ov,
         "--eval-names", "synth_obj1", "eval.batch_size=1"])
    assert abs(ir - workflow["ir"]) < 1e-6
    assert len(list((tmp_path / "res" / "synth_obj1").glob("*.npz"))) == 2
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_entry_point_runs_as_a_module(workflow):
    res = subprocess.run(
        [sys.executable, "-m", "pose6d_tpu_torch.cli.ir_extraction",
         str(workflow["base"] / "poses" / "results_poses_RANSAC" /
             "results")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert "overall mean IR" in res.stdout and "(n=2)" in res.stdout


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"],
                                  ["--process-id", "0"]],
                         ids=lambda f: f[0])
@pytest.mark.parametrize("cli", ["train", "eval"])
def test_multihost_flags_raise(cli, flag, tmp_path):
    """The JAX CLIs' multi-host flags are accepted and refused, naming
    the ROADMAP item: never ignored."""
    argv = ["--config", CONFIG, "--device", "cpu", *flag,
            f"logging_dir={tmp_path}"]
    main = cli_train.main
    if cli == "eval":
        argv += ["--weights", str(tmp_path / "w.msgpack")]
        main = cli_eval.main
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        main(argv)


def test_eval_refuses_reference_pt_weights(workflow, tmp_path):
    """cli.eval reads a .pt as the reference's weights.pt (held to the
    msgpack path in tests/test_torch_model_selection.py); a .pt without
    that layout is refused, naming the first missing key."""
    bad = tmp_path / "weights.pt"
    torch.save({"feature_extractor.first_lin.weight": torch.zeros(64, 3)},
               bad)
    with pytest.raises(KeyError, match="feature_extractor.first_lin.bias"):
        cli_eval.main(["--config", CONFIG, "--device", "cpu", "--weights",
                       str(bad), *workflow["overrides"]])


def test_stage_timer_summary():
    from pose6d_tpu_torch.utils import StageTimer
    timer = StageTimer()
    for _ in range(3):
        with timer("stage", sync_value=torch.zeros(1)):
            torch.ones(8).sum()
    out = timer.summary()
    assert list(out) == ["stage"] and out["stage"]["n"] == 3
    assert out["stage"]["mean_ms"] >= 0.0


def test_train_without_datasets_raises():
    """No dataset and no train_datasets block: train() refuses instead of
    running zero steps."""
    from pose6d_tpu_torch.config import Config
    from pose6d_tpu_torch.train.loop import train
    with pytest.raises(ValueError, match="train_datasets is empty"):
        train(Config(), device="cpu")
