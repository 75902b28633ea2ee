"""The cached pose path pinned bit for bit: `api.pose_from_operators` (an
xyz and an xyz_hks model) and `Predictor.predict_with_operators` on
seeded small cases equal the outputs recorded in
`tests/data/pose_pinned.npz`. The file also holds the cases' host
operators (scipy's eigsh starts from a random vector, so their evecs
differ run to run in the last bits). The pose path of the benchmark's
`orig.pose_b64` cell is this code at a larger size, so a change to its
arithmetic shows here first.

Re-record the golden only for a deliberate change of that arithmetic:

    python tests/test_torch_pose_pinned.py --write

which recomputes the outputs on the file's saved inputs (add
`--new-inputs` to make the inputs anew as well).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu_torch.api import Predictor, pad_operators, pose_from_operators
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.models import DPFMConfig, DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.spectral.operators import point_cloud_operators

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "pose_pinned.npz"
HYPOTHESES, ICP_ITERS, STRIDE = 1024, 6, 2
V_CAD, V_PC, K_EIG = 640, 256, 32


OPS = ("xyz", "mass", "evals", "evecs")


def _frames():
    """Two random_shape CADs (514 points, diameter 14) and their partial
    clouds (200 of the points moved by a seeded pose, at z = 50), as host
    operators."""
    rng = np.random.default_rng(0)
    out = []
    for seed in (3, 8):
        verts, _ = random_shape(seed, nu=16, nv=32)
        verts = verts * (14.0 / np.linalg.norm(verts.max(0) - verts.min(0)))
        R = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        pts = verts[rng.permutation(len(verts))[:200]] @ R.T + [0, 0, 50]
        out.append((point_cloud_operators(verts, k_eig=K_EIG),
                    point_cloud_operators(pts, k_eig=K_EIG)))
    return out


def _batch(frames):
    stack = lambda ps: {k: torch.stack([p[k] for p in ps])  # noqa: E731
                        for k in ps[0]}
    cad = stack([pad_operators(c, V_CAD, "cpu") for c, _ in frames])
    pc = stack([pad_operators(p, V_PC, "cpu") for _, p in frames])
    diam = torch.tensor([float(np.linalg.norm(c["xyz"].max(0)
                                              - c["xyz"].min(0)))
                         for c, _ in frames])
    return cad, pc, diam


def _uniforms(bsz: int, seed: int):
    return torch.rand((bsz, HYPOTHESES // 512, 512, 3),
                      generator=torch.Generator().manual_seed(seed))


def saved_frames(golden) -> list:
    """The cases' host operators as `_frames` made them for the golden."""
    return [tuple({k: golden[f"in.{i}.{side}.{k}"] for k in OPS}
                  for side in ("cad", "pc")) for i in range(2)]


def outputs(frames) -> dict:
    """Every pinned output on `frames`, {name: array}."""
    cad, pc, diam = _batch(frames)
    res = {}
    for name, features in (("xyz", "xyz"), ("hks", "xyz_hks")):
        torch.manual_seed(0)
        model = DPFMNet(DPFMConfig(k_eig=K_EIG,
                                   input_features=features)).eval()
        with torch.inference_mode():
            out = pose_from_operators(model, cad, pc, diam,
                                      n_hypotheses=HYPOTHESES,
                                      icp_iters=ICP_ITERS,
                                      coarse_stride=STRIDE,
                                      uniforms=_uniforms(2, 1))
        res.update({f"{name}.{k}": v.numpy() for k, v in out.items()})
    model = load_flax_checkpoint(ROOT / "weights" / "synth_seen.msgpack",
                                 DPFMNet(DPFMConfig(k_eig=K_EIG)))
    pred = Predictor(model, {3: frames[0][0]}, mode="cached", v_cad=V_CAD,
                     v_pc=V_PC, ransac_hypotheses=HYPOTHESES,
                     icp_iters=ICP_ITERS, device="cpu")
    with torch.inference_mode():
        out = pred.predict_with_operators(3, frames[0][1],
                                          uniforms=_uniforms(1, 2)[0].numpy())
    res.update({f"predictor.{k}": np.asarray(v) for k, v in out.items()})
    return res


@pytest.fixture(scope="module")
def pinned():
    return outputs(saved_frames(np.load(GOLDEN)))


@pytest.mark.parametrize("prefix", ["xyz", "hks", "predictor"])
def test_pose_path_bit_for_bit(pinned, prefix):
    golden = np.load(GOLDEN)
    keys = sorted(k for k in golden.files if k.startswith(prefix + "."))
    assert keys
    assert sorted(k for k in pinned if k.startswith(prefix + ".")) == keys
    for k in keys:
        a, b = pinned[k], golden[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


if __name__ == "__main__" and "--write" in sys.argv:
    GOLDEN.parent.mkdir(exist_ok=True)
    if GOLDEN.exists() and "--new-inputs" not in sys.argv:
        saved = np.load(GOLDEN)
        inputs = {k: saved[k] for k in saved.files if k.startswith("in.")}
    else:
        inputs = {f"in.{i}.{side}.{k}": np.asarray(ops[k])
                  for i, pair in enumerate(_frames())
                  for side, ops in zip(("cad", "pc"), pair) for k in OPS}
    np.savez(GOLDEN, **inputs, **outputs(saved_frames(inputs)))
    print("wrote", GOLDEN)
