"""The cell hks.flip_b64 on the CPU at a tiny size (the pose cell's tiny
traffic): a sound run comes out correct, plain and traced, and `correct`
comes out false where the flip stage is broken underneath (its answer
left at the base pose on every frame; its winner's refine skipped) and
for the TF32 control."""
import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import POSE

CELL = "hks.flip_b64"
SEED = 2**41 + 9


def run(trace=False):
    return harness.run_cell(CELL, SEED, 0.3, trace, time.perf_counter(),
                            device="cpu", overrides=POSE)


def patch_flip(monkeypatch, fn):
    import pose6d_tpu_torch.api as api
    import pose6d_tpu_torch.solvers as solvers
    real = solvers.disambiguate_pose_depth

    def flip(*args, **kw):
        return fn(real, *args, **kw)
    monkeypatch.setattr(api, "disambiguate_pose_depth", flip)
    monkeypatch.setattr(solvers, "disambiguate_pose_depth", flip)


def flips_skipped(real, cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0, *a,
                  **kw):
    out = real(cad_xyz, cad_valid, pc_xyz, pc_valid, R0, t0, *a, **kw)
    return dict(out, R=R0.float(), t=t0.float())


def refine_skipped(real, *a, **kw):
    return real(*a, **dict(kw, icp_iters=kw.get("bank_iters", 5)))


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    r = run(trace)
    assert r["correct"], r["checks"]
    assert {"flip_apart", "flip_rmse_gap"} <= set(r["checks"])
    if trace:
        assert {"flip_ms", "flip_changed_share", "flip_bank_live_share",
                "pose_flip_mfu"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", [flips_skipped, refine_skipped],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(monkeypatch, fault):
    patch_flip(monkeypatch, fault)
    r = run()
    assert not r["correct"], r["checks"]


def test_control_is_caught():
    from benchmark.control import readings
    lines = readings(CELL, SEED, 0.3, True, device="cpu", overrides=POSE)
    limits = harness.load_cell(CELL)["limits"]
    ctl = next(x for x in lines if x["who"] == "control_tf32")["numbers"]
    assert any(v > limits[k] for k, v in ctl.items()), ctl


def test_parent_program_fails_at_once(monkeypatch):
    """A program without the entry fails in set-up before the input pool
    starts."""
    import pose6d_tpu_torch.api as api
    from benchmark.inputs import depth_frames
    monkeypatch.delattr(api, "pose_from_depth_operators")
    monkeypatch.setattr(depth_frames, "start_pool", None)
    with pytest.raises(ImportError):
        run()
