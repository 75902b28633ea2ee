"""The plain reference against the port at a tiny size on the CPU, stage
by stage, as `correct` compares them on the card."""
import pytest

from benchmark.control import readings
from benchmark.tests.tiny import TINY


def test_pose_stages_agree():
    r = readings("orig.pose_b64", 2**40 + 3, 0.3, False, device="cpu",
                 overrides=TINY["orig.pose_b64"])[0]["numbers"]
    assert r["C_gap"] < 2e-3 and r["overlap_gap"] < 1e-4
    assert r["filter_apart"] < 0.01
    assert r["ransac_apart"] == 0 and r["icp_apart"] == 0
    assert r["rmse_gap"] < 1e-4


@pytest.mark.parametrize("name", ["f64", "f32", "tf32"])
def test_tf32_rounding(name):
    import torch
    from benchmark.reference.precision import Prec, to_tf32
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9])
    assert to_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                   -3.0 - 2.0 ** -9]
    p = Prec(name)
    a = torch.randn(4, 3, dtype=p.dtype)
    b = torch.randn(3, 2, dtype=p.dtype)
    want = (to_tf32(a) @ to_tf32(b)) if name == "tf32" else a @ b
    assert torch.equal(p.mm(a, b), want)
