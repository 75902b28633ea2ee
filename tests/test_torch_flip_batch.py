"""`api.pose_from_depth_operators` (the batched pose path with depth-render
flip disambiguation) on the CPU at small shapes: it is
pose_from_operators followed by disambiguate_pose_depth bit for bit; a
batch of frames with different flip banks agrees frame by frame with
calls at B = 1; it agrees with the benchmark's plain reference
(benchmark/reference/model.py and flip.py) on seeded random weights of
an xyz_hks model; and the flip stage's counters count while the
profiler records, and not otherwise.

The frames are the benchmark's (benchmark/inputs/depth_frames.py) at a
test size: random_shape meshes of 514 vertices rendered at 640 x 480,
clouds of 400 farthest points, 32 eigenvectors."""
import numpy as np
import pytest
import torch

from benchmark.inputs.depth_frames import intrinsics, shape_task
from benchmark.reference import flip as ref_flip
from benchmark.reference import model as ref_model
from benchmark.reference import pose as ref_pose
from benchmark.reference.precision import Prec
from benchmark.reference.weights import read_params
from pose6d_tpu_torch.api import (pad_operators, pose_from_depth_operators,
                                  pose_from_operators)
from pose6d_tpu_torch.models import DPFMConfig, DPFMNet
from pose6d_tpu_torch.models.weights import save_flax_params
from pose6d_tpu_torch.ops.symmetry import disambiguation_bank
from pose6d_tpu_torch.solvers.multistart import disambiguate_pose_depth
from pose6d_tpu_torch.utils.profiling import collect, reset

torch.set_num_threads(2)
SPEC = {"max_pc": 400, "k_eig": 32, "nu": 16, "nv": 32}
V_CAD, V_PC = 640, 512
HYPOTHESES, ICP_ITERS, STRIDE = 1024, 6, 2
MODEL = {"fmap": {"n_fmap": 30, "k_eig": 32, "n_feat": 32, "C_in": 3,
                  "lambda_": 100, "resolvant_gamma": 0.5, "robust": True,
                  "input_features": "xyz_hks", "n_hks": 16},
         "attention": {"num_head": 2, "gnn_dim": 32, "ref_n_layers": 1,
                       "cross_sampling_ratio": 1.0,
                       "attention_type": "normal"},
         "overlap": {"overlap_feat_dim": 32}}


@pytest.fixture(scope="module")
def case():
    """B = 4: two shapes (seeds 11 and 13, each with its own flip bank)
    in two poses each, a random-weight xyz_hks model and RANSAC draws."""
    shapes = [shape_task(s, 2, SPEC) for s in (11, 13)]
    for s in shapes:
        s["bank"] = disambiguation_bank(s["cad_ops"]["xyz"], max_rots=6)
    slots = [(s, f) for s in shapes for f in s["frames"]]

    def stack(parts):
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    torch.manual_seed(0)
    model = DPFMNet(DPFMConfig.from_yaml_dict(MODEL)).eval()
    batch = {
        "cad": stack([pad_operators(s["cad_ops"], V_CAD, "cpu")
                      for s, _ in slots]),
        "pc": stack([pad_operators(f["pc_ops"], V_PC, "cpu")
                     for _, f in slots]),
        "diam": torch.tensor([s["diam"] for s, _ in slots]),
        "K": torch.as_tensor(np.stack([intrinsics()] * len(slots))),
        "obs_z": torch.as_tensor(np.stack([f["depth_cm"] for _, f in slots])),
        "mask": torch.as_tensor(np.stack([f["mask"] for _, f in slots])),
        "sym_rots": torch.as_tensor(np.stack([s["bank"] for s, _ in slots])),
        "u": torch.rand((len(slots), HYPOTHESES // 512, 512, 3),
                        generator=torch.Generator().manual_seed(1))}
    return model, batch, slots


def entry(model, b):
    with torch.inference_mode():
        return pose_from_depth_operators(
            model, b["cad"], b["pc"], b["diam"], b["K"], b["obs_z"],
            b["mask"], b["sym_rots"], n_hypotheses=HYPOTHESES,
            icp_iters=ICP_ITERS, coarse_stride=STRIDE, uniforms=b["u"])


@pytest.fixture(scope="module")
def outputs(case):
    model, b, _ = case
    return entry(model, b)


def test_entry_is_pose_then_flips(case, outputs):
    model, b, _ = case
    with torch.inference_mode():
        base = pose_from_operators(model, b["cad"], b["pc"], b["diam"],
                                   n_hypotheses=HYPOTHESES,
                                   icp_iters=ICP_ITERS, coarse_stride=STRIDE,
                                   uniforms=b["u"])
        fix = disambiguate_pose_depth(
            b["cad"]["xyz"], b["cad"]["valid"], b["pc"]["xyz"],
            b["pc"]["valid"], base["R"], base["t"], b["diam"], b["K"],
            b["obs_z"], b["mask"], sym_rots=b["sym_rots"])
    want = dict(base, R=fix["R"], t=fix["t"], R0=base["R"], t0=base["t"],
                flip_hypothesis=fix["hypothesis"], flip_score=fix["score"],
                flip_rmse=fix["rmse"])
    assert list(outputs) == list(want)
    for k in want:
        assert torch.equal(outputs[k], want[k]), k
    # the banks differ between the shapes, and the base ICP's rmse stays
    assert not torch.equal(b["sym_rots"][0], b["sym_rots"][2])
    assert torch.equal(outputs["icp_rmse"], base["icp_rmse"])


def test_batch_agrees_with_single_frames(case, outputs):
    """Each frame alone (B = 1, its own bank and draws) against the batch
    of 4. Tolerance: the batched products (bmm, the solve, eigh) may
    block their sums otherwise at another batch size, so poses may move
    in the last bits: within 1e-5 (rotation entries, cm) and 1e-4 of the
    scores relative, the same flip hypothesis and RANSAC inliers."""
    model, b, slots = case
    for i in range(len(slots)):
        one = {k: ({kk: vv[i:i + 1] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[i:i + 1])
               for k, v in b.items()}
        out = entry(model, one)
        assert int(out["flip_hypothesis"][0]) == int(
            outputs["flip_hypothesis"][i])
        assert int(out["n_inliers"][0]) == int(outputs["n_inliers"][i])
        for k in ("R", "t", "R0", "t0"):
            torch.testing.assert_close(out[k][0], outputs[k][i], rtol=0,
                                       atol=1e-5)
        for k in ("flip_score", "flip_rmse", "icp_rmse"):
            torch.testing.assert_close(out[k][0], outputs[k][i], rtol=1e-4,
                                       atol=0)


RECIPE = {"icp_iters": 15, "bank_iters": 5, "coarse_stride": 4,
          "render_stride": 4, "margin": 0.25, "gate": 0.2}


def as64(d):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in d.items()}


def hold_to_reference(R0, t0, prog, b, margin: float) -> int:
    """reference/flip.py in float64 from (R0, t0) against the program's
    flip stage `prog` (R, t, hypothesis, rmse): on each frame whose
    handicapped float64 scores separate the winner from the next by more
    than 1 % (determined), the same hypothesis and the final pose within
    1e-3 of the diameter (the benchmark's TOL); on every frame, the
    program's rmse within 1e-4 of the float64 rmse of its own pose.
    Returns the number of determined frames."""
    f64 = Prec("f64")
    cad, pc, diam = as64(b["cad"]), as64(b["pc"]), b["diam"].double()
    want = ref_flip.flip_stage(cad, pc, R0.double(), t0.double(), diam,
                               b["K"].double(), b["obs_z"].double(),
                               b["mask"], b["sym_rots"].double(),
                               dict(RECIPE, margin=margin), f64)
    handicap = torch.tensor([1.0] + [1.0 + margin] * 5, dtype=torch.float64)
    ranked = torch.sort(want["scores"] * handicap, dim=-1).values
    determined = (ranked[:, 1] - ranked[:, 0]) > 0.01 * ranked[:, 0]
    x, w = cad["xyz"], cad["valid"].double()
    d = (x @ (prog["R"].double() - want["R"]).transpose(-1, -2)
         + (prog["t"].double() - want["t"])[:, None])
    gap = ((d.norm(dim=-1) * w).sum(-1) / w.sum(-1)) / diam
    for i in range(len(diam)):
        if determined[i]:
            assert int(prog["hypothesis"][i]) == int(want["hypothesis"][i])
            assert gap[i] < 1e-3, (i, float(gap[i]))
    rm = ref_pose.rmse_at(cad, pc, prog["R"].double(), prog["t"].double(),
                          0.2 * diam, f64)
    torch.testing.assert_close(prog["rmse"].double(), rm, rtol=1e-4, atol=0)
    return int(determined.sum())


def test_entry_agrees_with_plain_reference(case, outputs, tmp_path):
    """The model against reference/model.py on the same weights (float64;
    the largest |dC| within 1e-3 of max |C|, as HKS's time grid is
    torch.linspace there and XLA's rounding in the port), and the flip
    stage against reference/flip.py fed the program's base pose
    (hold_to_reference, at the entry's margin 0.25)."""
    model, b, _ = case
    f64 = Prec("f64")
    save_flax_params(tmp_path / "w.msgpack", model)
    params = ref_model.params_to(read_params(tmp_path / "w.msgpack"), f64,
                                 "cpu")
    m = ref_model.forward(params, MODEL, as64(b["cad"]), as64(b["pc"]), f64)
    C = outputs["C"].double()
    assert float(((C - m["C"]).abs().amax((1, 2))
                  / m["C"].abs().amax((1, 2))).max()) < 1e-3
    prog = {"R": outputs["R"], "t": outputs["t"],
            "hypothesis": outputs["flip_hypothesis"],
            "rmse": outputs["flip_rmse"]}
    assert hold_to_reference(outputs["R0"], outputs["t0"], prog, b,
                             0.25) >= 3


def flipped_truth(b, slots, **kw):
    """disambiguate_pose_depth from each frame's true pose turned by its
    bank's second rotation about the CAD centroid (hypothesis 1 undoes
    the turn); returns the start (R0, t0) and the stage's outputs."""
    R_gt = torch.tensor(np.stack([f["R"] for _, f in slots]),
                        dtype=torch.float32)
    t_gt = torch.tensor(np.stack([f["t"] for _, f in slots]),
                        dtype=torch.float32)
    cad = b["cad"]
    w = cad["valid"].float()[..., None]
    mu = (cad["xyz"] * w).sum(1) / w.sum(1)
    R0 = R_gt @ b["sym_rots"][:, 1].transpose(-1, -2)
    t0 = t_gt + (R_gt @ mu[..., None])[..., 0] - (R0 @ mu[..., None])[..., 0]
    fix = disambiguate_pose_depth(
        cad["xyz"], cad["valid"], b["pc"]["xyz"], b["pc"]["valid"], R0, t0,
        b["diam"], b["K"], b["obs_z"], b["mask"], sym_rots=b["sym_rots"],
        **kw)
    return R0, t0, fix


def test_flip_stage_agrees_with_reference_from_flipped_truth(case):
    """A winner other than the base, from flipped_truth. These
    near-symmetric shapes score the undoing flip under 25 % better, so
    the margin is 0 here. The program's disambiguate_pose_depth, held to
    reference/flip.py as hold_to_reference holds it, moves off the base
    on three frames of four (hypothesis 1 or another image of the
    truth)."""
    _, b, slots = case
    R0, t0, fix = flipped_truth(b, slots, margin=0.0)
    assert hold_to_reference(R0, t0, fix, b, 0.0) >= 3
    assert int((fix["hypothesis"] != 0).sum()) >= 3


def test_flip_counters(case, outputs):
    """While the profiler records: flip.frames B, flip.bank_rows B x 6,
    flip.changed the frames whose winner is not hypothesis 0 (none in the
    entry's batch, three in flipped_truth's at margin 0),
    flip.live_bank_rows the rows that are not an identity pad after row
    0. Without it nothing is counted, and the outputs are the same."""
    from torch.profiler import ProfilerActivity, profile
    model, b, slots = case
    reset()
    plain = entry(model, b)
    assert collect()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        traced = entry(model, b)
    c = collect()["counters"]
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    bsz, n_hyp = b["sym_rots"].shape[:2]
    eye = torch.eye(3)
    pads = sum(int(torch.equal(b["sym_rots"][i, h], eye))
               for i in range(bsz) for h in range(1, n_hyp))
    assert pads > 0
    assert c["flip.frames"] == bsz
    assert c["flip.bank_rows"] == bsz * n_hyp
    assert c["flip.live_bank_rows"] == bsz * n_hyp - pads
    assert c["flip.changed"] == int((outputs["flip_hypothesis"] != 0).sum())
    reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, fix = flipped_truth(b, slots, margin=0.0)
    c = collect()["counters"]
    assert c["flip.changed"] == int((fix["hypothesis"] != 0).sum()) >= 3
    assert c["flip.frames"] == bsz
