"""The port's spans and counters (utils/profiling.py) on the CPU, at small
shapes: the profiler changes no output bit; without it no annotation is
made and no counter moves; under it the pose path's spans nest in the
trace, RANSAC's live frame blocks are counted, profile_trace writes the
counters beside the trace, and the serving export stays node for node
as it is."""
import io
import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import pose6d_tpu_torch.api as torch_api
from pose6d_tpu_torch import serving
from pose6d_tpu_torch.api import Predictor, pad_operators, pose_from_operators
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.models import DPFMConfig, DPFMNet
from pose6d_tpu_torch.ops.kernels._build import count_launch
from pose6d_tpu_torch.solvers.ransac import ransac_pose
from pose6d_tpu_torch.spectral.operators import point_cloud_operators
from pose6d_tpu_torch.utils import profiling
from pose6d_tpu_torch.utils.profiling import (collect, profile_trace, reset,
                                              span)

torch.set_num_threads(2)
HYPOTHESES, ICP_ITERS, STRIDE = 1024, 6, 2


@pytest.fixture(scope="module")
def batch():
    """A random-weight k_eig = 32 DPFMNet and B = 2 frames: two
    random_shape CADs (514 points, padded to 640), each observed as 200
    of its points moved by a pose (padded to 256)."""
    rng = np.random.default_rng(0)
    cads, pcs, diams = [], [], []
    for seed in (3, 8):
        verts, _ = random_shape(seed, nu=16, nv=32)
        verts = verts * (14.0 / np.linalg.norm(verts.max(0) - verts.min(0)))
        R = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        pts = verts[rng.permutation(len(verts))[:200]] @ R.T + [0, 0, 50]
        cads.append(pad_operators(point_cloud_operators(verts, k_eig=32),
                                  640, "cpu"))
        pcs.append(pad_operators(point_cloud_operators(pts, k_eig=32),
                                 256, "cpu"))
        diams.append(float(np.linalg.norm(verts.max(0) - verts.min(0))))
    stack = lambda ps: {k: torch.stack([p[k] for p in ps])  # noqa: E731
                        for k in ps[0]}
    torch.manual_seed(0)
    model = DPFMNet(DPFMConfig(k_eig=32)).eval()
    u = torch.rand((2, HYPOTHESES // 512, 512, 3),
                   generator=torch.Generator().manual_seed(1))
    return model, stack(cads), stack(pcs), torch.tensor(diams), u


def run(batch):
    model, cad, pc, diam, u = batch
    return pose_from_operators(model, cad, pc, diam, n_hypotheses=HYPOTHESES,
                               icp_iters=ICP_ITERS, coarse_stride=STRIDE,
                               uniforms=u)


def profiled(fn, path):
    """fn() under torch.profiler; returns its result and the trace's
    pose6d annotation events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out, annotations(path)


def annotations(path) -> list:
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X" and e["name"].startswith("pose6d.")]


def parents(anns: list) -> list:
    """Each annotation's innermost enclosing pose6d annotation on its
    thread (None at the root), by the trace's own interval."""
    out = []
    for a in anns:
        holders = [b for b in anns if b is not a and b["tid"] == a["tid"]
                   and b["ts"] <= a["ts"]
                   and a["ts"] + a["dur"] <= b["ts"] + b["dur"]]
        out.append(min(holders, key=lambda b: b["dur"]) if holders else None)
    return out


def test_outputs_bit_identical_with_and_without_the_profiler(batch,
                                                            tmp_path):
    plain = run(batch)
    traced, anns = profiled(lambda: run(batch), tmp_path / "trace.json")
    assert anns
    assert set(plain) == set(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_no_profiler_no_annotation_and_counters_hold(batch, monkeypatch):
    """Without the profiler no record_function is made and no counter
    moves."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) without profiler")
    reset()
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    out = run(batch)
    with span("outer"):
        pass
    assert collect()["counters"] == {}
    assert torch.isfinite(out["R"]).all()


def test_profiled_spans_nest(batch, tmp_path):
    reset()
    out, anns = profiled(lambda: run(batch), tmp_path / "trace.json")
    counters = collect()["counters"]
    blocks = counters["ransac.frame_blocks"] // 2
    assert 1 <= blocks <= HYPOTHESES // 512
    names = [a["name"][len("pose6d."):] for a in anns]
    want_parent = {"pose": None, "model": "pose", "filter": "pose",
                   "ransac": "pose", "ransac.block": "ransac",
                   "ransac.refit": "ransac", "icp": "pose",
                   "icp.match": "icp", "icp.update": "icp"}
    assert sorted(set(names)) == sorted(want_parent)
    for a, p in zip(anns, parents(anns)):
        name = a["name"][len("pose6d."):]
        assert (p["name"][len("pose6d."):] if p else None) == \
            want_parent[name], name
    counts = {n: names.count(n) for n in want_parent}
    assert counts == {"pose": 1, "model": 1, "filter": 1, "ransac": 1,
                      "ransac.block": blocks, "ransac.refit": 1, "icp": 1,
                      "icp.match": ICP_ITERS + 1, "icp.update": ICP_ITERS}
    assert torch.equal(out["n_trials"].sum() // 512,
                       torch.tensor(counters["ransac.live_frame_blocks"]))


def test_ransac_live_frame_blocks(tmp_path):
    """Frame 0's pairs all agree (it exits after the first block), frame
    1's are noise (it draws every block): live = n_trials / block summed,
    frame_blocks = B x blocks run."""
    g = torch.Generator().manual_seed(4)
    src = torch.randn((2, 300, 3), generator=g) * 5
    R = torch.tensor(Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix(),
                     dtype=torch.float32)
    dst = src @ R.T + torch.tensor([1.0, 2.0, 3.0])
    dst[1] = torch.randn((300, 3), generator=g) * 5
    valid = torch.ones((2, 300), dtype=torch.bool)
    u = torch.rand((2, 4, 64, 3), generator=g)
    reset()
    out, anns = profiled(lambda: ransac_pose(
        src, dst, valid, threshold=0.05, n_hypotheses=256, hyp_block=64,
        uniforms=u), tmp_path / "trace.json")
    c = collect()["counters"]
    assert out["n_trials"].tolist() == [64, 256]
    assert c["ransac.live_frame_blocks"] == int(out["n_trials"].sum()) // 64
    assert c["ransac.frame_blocks"] == 2 * 4
    assert [a["name"] for a in anns].count("pose6d.ransac.block") == 4


def test_collect_reads_the_launch_counter(tmp_path):
    """collect()'s launches are ops/kernels LAUNCHES since reset(); a
    count made without the profiler is dropped."""
    count_launch("masked_argmin_cdist")
    reset()
    count_launch("masked_argmin_cdist")
    profiling.count("probe", 3)
    profiled(lambda: (count_launch("masked_argmin_cdist"),
                      profiling.count("probe", 2)), tmp_path / "t.json")
    rec = collect()
    assert rec["launches"]["masked_argmin_cdist"] == 2
    assert set(rec["launches"]) >= {"flash_cross_attention"}
    assert rec["counters"] == {"probe": 2}


def test_profile_trace_writes_spans_and_counters(batch, tmp_path):
    """profile_trace (cli eval --profile DIR): DIR/trace.json carries the
    program's spans, DIR/counters.json the block's counters alone."""
    reset()
    profiled(lambda: run(batch), tmp_path / "before.json")
    with profile_trace(str(tmp_path)):
        out = run(batch)
    names = {a["name"] for a in annotations(tmp_path / "trace.json")}
    assert {"pose6d.pose", "pose6d.ransac.block", "pose6d.icp.update"} \
        <= names
    saved = json.loads((tmp_path / "counters.json").read_text())
    assert saved["counters"]["ransac.live_frame_blocks"] == \
        int(out["n_trials"].sum()) // 512
    assert saved["counters"]["ransac.frame_blocks"] % 2 == 0
    assert saved == collect()


def test_export_graph_same_under_the_profiler(monkeypatch, tmp_path):
    """serving.export_predictor under torch.profiler gives the graph it
    gives without, node for node, and records no span or counter."""
    verts, _ = random_shape(5, nu=16, nv=32)
    verts = verts * (14.0 / np.linalg.norm(verts.max(0) - verts.min(0)))
    monkeypatch.setattr(torch_api, "MAX_RAW", 1024)
    torch.manual_seed(0)
    pred = Predictor(DPFMNet(DPFMConfig(k_eig=32)),
                     {3: point_cloud_operators(verts, k_eig=32)},
                     device="cpu", v_cad=640, v_pc=256, max_pc=250,
                     ransac_hypotheses=512, icp_iters=2, lobpcg_iters=5)

    def nodes(blob):
        graph = torch.export.load(io.BytesIO(blob)).graph
        return [(n.op, str(n.target), len(n.args)) for n in graph.nodes]

    plain = nodes(serving.export_predictor(pred, 3, (48, 64)))
    reset()
    blob, anns = profiled(lambda: serving.export_predictor(pred, 3, (48, 64)),
                          tmp_path / "trace.json")
    assert nodes(blob) == plain
    assert anns == [] and collect()["counters"] == {}
