"""The model-selection and analysis workflow through the port's CLIs on
the CPU, against the JAX package's commands on the same files: a
1-object, 2-frame dataset that the port writes, lm_synth.yaml's model
at full width and small pads, trained 3 steps with a checkpoint each
(the curve ckpt_*.pt), then

- probe_ckpts over the curve (JAX's over the matching msgpack curve of
  train states built here): the same steps and records, IR within 1e-4
  (both round to 4 digits; JAX's f32 forward sums in another order);
- swa of the curve: bit for bit JAX's average of the msgpack curve, and
  cli.eval on the averaged params;
- resolve (spatial filter at k = 3 with another schedule, and naive) on
  copies of the eval results: p_pred and ir exactly JAX's;
- sym_ir's report and sym_inlier_ratio: JAX's, key for key;
- visualize basis / features / corr: the PLY files byte for byte JAX's;
- ref_results: the pose stage's txt parsed as JAX parses it, its T_gt
  the result file's pose;
- the reference's weights.pt layout: port_reference_checkpoint equal to
  JAX's on a state dict laid out with the reference's keys (built from
  a port model), and a .pt through load_pretrained_params and cli.eval.
"""
import json
import shutil
import sys

import numpy as np
import pytest
import torch
from flax import serialization

import pose6d_tpu.cli.probe_ckpts as jax_probe
import pose6d_tpu.cli.resolve as jax_resolve
import pose6d_tpu_torch.train.pose_stage as port_pose_stage
from pose6d_tpu.cli import sym_ir as jax_sym_ir
from pose6d_tpu.cli import visualize as jax_visualize
from pose6d_tpu.cli.swa import average_checkpoints as jax_average
from pose6d_tpu.models.port_weights import \
    port_reference_checkpoint as jax_port_reference
from pose6d_tpu.ops.symmetry import sym_inlier_ratio as jax_sym_ir_ratio
from pose6d_tpu.utils.ref_results import load_result_dir as jax_load_results
from pose6d_tpu_torch.cli import (eval as cli_eval, gen_shapes,
                                  generate_cache, pose, probe_ckpts, resolve,
                                  swa, sym_ir, synth_data, train as cli_train,
                                  visualize)
from pose6d_tpu_torch.models import DPFMNet, init_like_flax
from pose6d_tpu_torch.models.port_weights import port_reference_checkpoint
from pose6d_tpu_torch.models.weights import (flax_from_state_dict,
                                             read_flax_msgpack,
                                             state_dict_from_flax)
from pose6d_tpu_torch.ops.symmetry import sym_inlier_ratio
from pose6d_tpu_torch.train.loop import load_pretrained_params
from pose6d_tpu_torch.utils.ref_results import (load_result_dir,
                                                parse_result_txt)

from test_torch_cli import CONFIG, overrides
from test_torch_eval import f32_attention

torch.set_num_threads(2)

STEPS = 3
PAD = 512


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("selection")
    ov = [o for o in overrides(base) if not o.startswith("train.max_steps")]
    ov += [f"train.max_steps={STEPS}", "train.checkpoint_interval=1",
           "train.checkpoint_keep=5"]
    gen_shapes.main([str(base / "models"), "--count", "1", "--nu", "24",
                     "--nv", "48"])
    synth_data.main([str(base / "data"), "--models", str(base / "models"),
                     "--objects", "1", "--frames", "2", "--z-range", "2800",
                     "3200"])
    assert generate_cache.main(["--config", CONFIG, "--device", "cpu",
                                "--serial", *ov]) == 0
    cli_train.main(["--config", CONFIG, "--device", "cpu", *ov])
    (run_dir,) = (base / "logs").iterdir()
    weights = run_dir / "params_latest.msgpack"
    cli_eval.main(["--config", CONFIG, "--device", "cpu", "--weights",
                   str(weights), "--save-results", *ov])
    # the JAX package's curve: a train state msgpack per port checkpoint
    jax_run = base / "jax_run"
    (jax_run / "ckpt").mkdir(parents=True)
    for c in sorted((run_dir / "ckpt").glob("ckpt_*.pt")):
        state = torch.load(c, weights_only=True)
        params = flax_from_state_dict(state["model"])
        (jax_run / "ckpt" / f"{c.stem}.msgpack").write_bytes(
            serialization.msgpack_serialize(
                {"params": {"params": params}, "step": state["step"]}))
    return {"base": base, "overrides": ov, "run": run_dir,
            "jax_run": jax_run, "weights": weights,
            "results": base / "results"}


def _jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    return module.main()


def test_curve_has_every_step(run):
    steps = [swa.checkpoint_step(c) for c in swa.select_paths(run["run"])]
    assert steps == list(range(1, STEPS + 1))


def test_probe_ckpts_matches_jax(run, monkeypatch, tmp_path):
    f32_attention(monkeypatch)
    pads = ["--pad-cad", "1280", "--pad-pc", "1024"]
    out = tmp_path / "port.jsonl"
    recs = probe_ckpts.main(["--config", CONFIG, "--device", "cpu", "--run",
                             str(run["run"]), "--out", str(out), *pads,
                             "--eval-names", "synth_obj1",
                             *run["overrides"]])
    ref_out = tmp_path / "jax.jsonl"
    _jax_main(monkeypatch, jax_probe,
              ["--config", CONFIG, "--run", str(run["jax_run"]), "--out",
               str(ref_out), *pads, *run["overrides"], "--eval-names",
               "synth_obj1"])
    got = [json.loads(ln) for ln in out.read_text().splitlines()]
    ref = [json.loads(ln) for ln in ref_out.read_text().splitlines()]
    assert got == recs and len(got) == len(ref) == STEPS + 1
    for a, b in zip(got[:-1], ref[:-1]):
        assert a["step"] == b["step"] and a["per_obj"].keys() == \
            b["per_obj"].keys()
        assert abs(a["mean_ir"] - b["mean_ir"]) <= 1e-4
        for k in a["per_obj"]:
            assert abs(a["per_obj"][k] - b["per_obj"][k]) <= 1e-4
    assert got[-1].keys() == {"best_step", "best_mean_ir"}
    assert got[-1]["best_mean_ir"] == max(r["mean_ir"] for r in got[:-1])
    # --every and --min-step select from the curve as JAX's do
    sub = probe_ckpts.main(["--config", CONFIG, "--device", "cpu", "--run",
                            str(run["run"]), "--every", "2", "--min-step",
                            "2", *pads, "--eval-names", "synth_obj1",
                            *run["overrides"]])
    assert [r["step"] for r in sub[:-1]] == [2]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def test_swa_matches_jax_exactly(run, tmp_path):
    out = tmp_path / "swa.msgpack"
    swa.main(["--run", str(run["run"]), "--out", str(out), "--device",
              "cpu"])
    got = _flat(read_flax_msgpack(out))
    ref = _flat(jax_average(sorted((run["jax_run"] / "ckpt").glob(
        "ckpt_*.msgpack"))))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the JAX package reads the file the port wrote
    back = _flat(serialization.msgpack_restore(out.read_bytes()))
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # a window (steps 2..3) as JAX averages it, and the average moved off
    # the last checkpoint
    swa.main(["--run", str(run["run"]), "--min-step", "2", "--out",
              str(tmp_path / "w.msgpack"), "--device", "cpu"])
    win = _flat(read_flax_msgpack(tmp_path / "w.msgpack"))
    ref_win = _flat(jax_average(sorted((run["jax_run"] / "ckpt").glob(
        "ckpt_*.msgpack"))[1:]))
    for k in ref_win:
        np.testing.assert_array_equal(win[k], ref_win[k], err_msg=k)
    last = flax_from_state_dict(torch.load(
        run["run"] / "ckpt" / f"ckpt_{STEPS:08d}.pt",
        weights_only=True)["model"])
    assert any(not np.array_equal(got[k], v)
               for k, v in _flat({"params": last}).items())
    (ir, _), = cli_eval.main(["--config", CONFIG, "--device", "cpu",
                              "--weights", str(out), *run["overrides"]])
    assert 0.0 <= ir <= 1.0


def test_swa_refuses_different_trees(run, tmp_path):
    bad = tmp_path / "run"
    shutil.copytree(run["run"] / "ckpt", bad / "ckpt")
    c = sorted((bad / "ckpt").glob("ckpt_*.pt"))[-1]
    state = torch.load(c, weights_only=True)
    state["model"].pop(next(iter(state["model"])))
    torch.save(state, c)
    with pytest.raises(ValueError, match="different parameter tree"):
        swa.average_checkpoints(swa.select_paths(bad))
    with pytest.raises(SystemExit):
        swa.select_paths(bad, min_step=100)


@pytest.mark.parametrize("solver", ["spatial_k3", "naive"])
def test_resolve_matches_jax(run, solver, monkeypatch, tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(run["results"], port_dir)
    shutil.copytree(run["results"], jax_dir)
    flags = (["--topk", "3", "--taus", "0.35", "0.2", "0.1", "0.12"]
             if solver == "spatial_k3" else ["--solver", "naive"])
    irs = resolve.main([str(port_dir), "--device", "cpu", *flags])
    _jax_main(monkeypatch, jax_resolve, [str(jax_dir), *flags])
    files = sorted(port_dir.glob("result_*.npz"))
    assert len(irs) == len(files) == 2
    for f in files:
        a, b = dict(np.load(f)), dict(np.load(jax_dir / f.name))
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["p_pred"], b["p_pred"])
        assert a["p_pred"].dtype == b["p_pred"].dtype
        assert float(a["ir"]) == float(b["ir"])
        for k in a:
            if k not in ("p_pred", "ir"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sym_ir_matches_jax(run, tmp_path):
    got = sym_ir.analyze(run["results"])
    ref = jax_sym_ir.analyze(run["results"])
    assert got == ref
    out = tmp_path / "report.json"
    report = sym_ir.main([str(run["results"]), "--out", str(out)])
    assert report == got
    assert json.loads(out.read_text()).keys() == {"per_object", "mean",
                                                  "rel_tau"}
    d = np.load(sorted(run["results"].glob("result_*.npz"))[0])
    rng = np.random.default_rng(0)
    Rs = np.stack([np.eye(3), *(np.linalg.qr(rng.normal(size=(3, 3)))[0]
                                for _ in range(3))]).astype(np.float32)
    thr = 0.1 * float(d["diam_cad"])
    for rots in (Rs[:1], Rs):
        assert sym_inlier_ratio(d["p_pred"], d["cad_xyz"], d["align_pc"],
                                thr, rots) == jax_sym_ir_ratio(
            d["p_pred"], d["cad_xyz"], d["align_pc"], thr, rots)


def _tree_bytes(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("what", ["basis", "features", "corr"])
def test_visualize_ply_bytes_match_jax(run, what, monkeypatch, tmp_path):
    if what == "basis":
        npz = next((run["base"] / "cache").rglob("0_0_pc_LBO.npz"))
    else:
        npz = sorted(run["results"].glob("result_*.npz"))[0]
    visualize.main([what, str(npz), str(tmp_path / "port")])
    _jax_main(monkeypatch, jax_visualize, [what, str(npz),
                                           str(tmp_path / "jax")])
    got, ref = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got and got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], name


def test_ref_results_round_trip_the_pose_stage(run, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pose_stage, "PAIR_PAD", PAD)
        mp.setattr(port_pose_stage, "PT_PAD", PAD)
        pose.main(["ransac", str(run["results"]), str(tmp_path / "poses"),
                   "--device", "cpu", "--hypotheses", "1024", "--no-ply"])
    txt = tmp_path / "poses" / "results_poses_RANSAC" / "results"
    got, ref = load_result_dir(txt), jax_load_results(txt)
    assert got and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
        # the txt's T_gt is the result file's pose (printed by numpy)
        i = int(a["path"].rsplit("_", 1)[1].split(".")[0])
        r = np.load(run["results"] / f"result_{i:06d}.npz")
        np.testing.assert_allclose(a["T_gt"][:3, :3], r["R_m2c"], atol=1e-6)
        np.testing.assert_allclose(a["T_gt"][:3, 3], r["t_m2c"], rtol=1e-6)
        assert parse_result_txt(a["path"]).keys() | {"path"} == a.keys()


def reference_state_dict(model) -> dict:
    """A port model's weights laid out as the reference's weights.pt:
    its module names, Linear weights (out, in) and the refiner's 1x1
    Conv1d weights (out, in, 1)."""
    tree = flax_from_state_dict(model.state_dict())
    sd = {}

    def put(key, leaf, conv=False):
        w = torch.as_tensor(leaf["kernel"]).T.contiguous()
        sd[f"{key}.weight"] = w[..., None] if conv else w
        sd[f"{key}.bias"] = torch.as_tensor(leaf["bias"])

    fe, fr = tree["feature_extractor"], tree["feat_refiner"]
    for name in ("first_lin", "last_lin"):
        put(f"feature_extractor.{name}", fe[name])
        put(f"feat_refiner.{name}", fr[name])
    for b in (0, 1):
        blk = fe[f"block_{b}"]
        sd[f"feature_extractor.block_{b}.diffusion.diffusion_time"] = \
            torch.as_tensor(blk["diffusion_time"])
        for i in range(3):
            put(f"feature_extractor.block_{b}.mlp.miniMLP_mlp_layer_{i:03d}",
                blk["mlp"][f"layer_{i:03d}"])
    li = 0
    while f"layer_{li}" in fr:
        base, layer = f"feat_refiner.layers.{li}", fr[f"layer_{li}"]
        for j, proj in enumerate(("proj_q", "proj_k", "proj_v")):
            put(f"{base}.attn.proj.{j}", layer["attn"][proj], conv=True)
        put(f"{base}.attn.merge", layer["attn"]["merge"], conv=True)
        put(f"{base}.mlp.0", layer["mlp"]["lin_0"], conv=True)
        put(f"{base}.mlp.3", layer["mlp"]["lin_1"], conv=True)
        li += 1
    put("feat_refiner.overlap_predictor.overlap_score_net.0",
        fr["overlap"]["lin0"])
    put("feat_refiner.overlap_predictor.overlap_score_net.2",
        fr["overlap"]["lin1"])
    return sd


def test_port_reference_checkpoint_matches_jax(tmp_path):
    model = init_like_flax(DPFMNet(), torch.Generator().manual_seed(3))
    sd = reference_state_dict(model)
    got = port_reference_checkpoint(sd)
    ref = jax_port_reference(sd)
    fg, fr = _flat(got), _flat(ref)
    assert fg.keys() == fr.keys()
    for k in fr:
        np.testing.assert_array_equal(fg[k], np.asarray(fr[k]), err_msg=k)
    # through a .pt file and load_pretrained_params: the model's weights
    pt = tmp_path / "weights.pt"
    torch.save(sd, pt)
    template = {"params": flax_from_state_dict(DPFMNet().state_dict())}
    loaded = load_pretrained_params(str(pt), template)
    back = DPFMNet()
    back.load_state_dict(state_dict_from_flax(loaded["params"]), strict=True)
    for name, t in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], t), name
    # a layout without the reference's keys raises, naming the first one
    torch.save({"feature_extractor.first_lin.weight": torch.zeros(3, 3)}, pt)
    with pytest.raises(KeyError, match="first_lin.bias"):
        load_pretrained_params(str(pt), template)


def test_eval_reads_reference_pt_weights(run, tmp_path):
    """cli.eval --weights weights.pt gives the IR of the same weights
    as a flax msgpack file."""
    model = DPFMNet()
    model.load_state_dict(state_dict_from_flax(read_flax_msgpack(
        run["weights"])["params"]))
    pt = tmp_path / "weights.pt"
    torch.save(reference_state_dict(model), pt)
    argv = ["--config", CONFIG, "--device", "cpu", *run["overrides"]]
    (ir_pt, _), = cli_eval.main([*argv, "--weights", str(pt)])
    (ir, _), = cli_eval.main([*argv, "--weights", str(run["weights"])])
    assert ir_pt == ir
