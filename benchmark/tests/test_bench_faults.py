"""A run of each cell on the CPU at a tiny size, every step of it but the
look for a card, with the timed path broken underneath: `correct` has to
come out false for each fault the cell can have (ICP's step returning
its state unchanged on every slot or on a quarter of them; half of the
batch left out; an answer altered where it is produced; one card, so no
exchange between cards). The same run with
nothing broken comes out correct, and so does its traced form."""
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import TINY

SEED = 2**41 + 9


def run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.3, trace, time.perf_counter(),
                            device="cpu", overrides=TINY[cell])


def icp_unchanged(monkeypatch):
    import pose6d_tpu_torch.solvers as solvers
    import pose6d_tpu_torch.solvers.candidates as cand

    def icp(cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0, **kw):
        z = torch.zeros(R0.shape[0])
        return {"R": R0.float(), "t": t0.float(), "rmse": z, "n_corr": z}
    monkeypatch.setattr(cand, "icp_cloud_to_model", icp)
    monkeypatch.setattr(solvers, "icp_cloud_to_model", icp)


def pose_half(monkeypatch):
    import pose6d_tpu_torch.api as api
    real = api.candidate_select_pose

    def half(model, cad, pc, diam, **kw):
        out = real(model, cad, pc, diam, **kw)
        h = out["R"].shape[0] // 2
        return {k: torch.cat([v[:h], v[:h]]) for k, v in out.items()}
    monkeypatch.setattr(api, "candidate_select_pose", half)


def map_altered(monkeypatch):
    from pose6d_tpu_torch.models import dpfm
    real = dpfm.DPFMNet.forward

    def forward(self, cad, pc):
        out = real(self, cad, pc)
        return dict(out, C=out["C"] * 1.1)
    monkeypatch.setattr(dpfm.DPFMNet, "forward", forward)


def icp_quarter_skipped(monkeypatch):
    import pose6d_tpu_torch.solvers as solvers
    import pose6d_tpu_torch.solvers.candidates as cand
    real = solvers.icp_cloud_to_model

    def icp(cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0, **kw):
        out = real(cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0, **kw)
        n = R0.shape[0] // 4
        return dict(out, R=torch.cat([R0[:n].float(), out["R"][n:]]),
                    t=torch.cat([t0[:n].float(), out["t"][n:]]))
    monkeypatch.setattr(cand, "icp_cloud_to_model", icp)
    monkeypatch.setattr(solvers, "icp_cloud_to_model", icp)


@pytest.mark.parametrize("cell,trace", [("orig.pose_b64", False),
                                        ("orig.pose_b64", True)])
def test_sound_run_is_correct(cell, trace):
    r = run(cell, trace)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("orig.pose_b64", icp_unchanged), ("orig.pose_b64", pose_half),
    ("orig.pose_b64", map_altered), ("orig.pose_b64", icp_quarter_skipped)],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["orig.pose_b64"])
def test_control_is_caught(cell):
    """The reference in TF32 put in the program's place fails a limit."""
    from benchmark.control import readings
    lines = readings(cell, SEED, 0.3, True, device="cpu",
                     overrides=TINY[cell])
    limits = harness.load_cell(cell)["limits"]
    ctl = next(x for x in lines if x["who"] == "control_tf32")["numbers"]
    assert any(v > limits[k] for k, v in ctl.items()), ctl


@pytest.mark.card
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell("orig.pose_b64", SEED, 2.0, False,
                         time.perf_counter())
    assert r["correct"], r["checks"]
