"""annotations.read_annotations on hand-made Chrome traces (a gap that
straddles a span's edge, a sync call outside every span, a span nested
in one of its own name), and the benchmark's existing readers, which
read the same numbers whether or not the trace holds the program's
pose6d.* annotations, and the readers of the program's spans and
counters."""
import json

import pytest

from benchmark import annotations, harness, traces
from benchmark.annotations import read_annotations
from benchmark.drivers.pose_from_operators import KERNEL_GROUPS


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def runtime(name, ts, dur=1.0, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return path


# device busy [0, 10], [20, 30], [50, 60], [100, 110]: gaps (10, 20),
# (30, 50), (60, 100)
DEVICE = [kernel("k", 0, 10), kernel("k", 20, 10), kernel("k", 50, 5),
          kernel("k", 52, 8), kernel("k", 100, 10)]


def test_idle_and_syncs_inside_spans(tmp_path):
    events = DEVICE + [
        ann("pose6d.icp", 15, 40),              # [15, 55]: the gap (10, 20)
        ann("pose6d.icp", 25, 20),              # nested, counts once
        ann("pose6d.ransac", 58, 47),           # [58, 105]
        runtime("cudaStreamSynchronize", 40),   # inside icp
        runtime("cudaMemcpyAsync", 80),         # inside ransac
        runtime("cudaStreamSynchronize", 115),  # outside every span
        runtime("cudaLaunchKernel", 30)]        # not a sync call
    got = read_annotations(write(tmp_path, events),
                           ["pose6d.icp", "pose6d.ransac", "pose6d.model"], 2)
    assert set(got) == {"pose6d.icp", "pose6d.ransac"}
    icp, ransac = got["pose6d.icp"], got["pose6d.ransac"]
    # icp: 15..20 of (10, 20) and 30..50 of (30, 50); halved by n_items
    assert icp["idle_s"] == pytest.approx(25e-6 / 2)
    assert icp["sync_calls"] == 0.5
    assert icp["span_s"] == pytest.approx(40e-6 / 2)
    assert icp["count"] == 2
    # ransac: 60..100 of (60, 100); not the time after the last device op
    assert ransac["idle_s"] == pytest.approx(40e-6 / 2)
    assert ransac["sync_calls"] == 0.5
    assert ransac["count"] == 1


def test_overlapping_spans_of_one_name_count_once(tmp_path):
    events = DEVICE + [ann("pose6d.icp.update", 12, 10),
                       ann("pose6d.icp.update", 18, 15, tid=2)]
    got = read_annotations(write(tmp_path, events), ["pose6d.icp.update"], 1)
    # union [12, 33]: 12..20 and 30..33
    assert got["pose6d.icp.update"]["idle_s"] == pytest.approx(11e-6)


def realistic(with_program_spans: bool) -> list:
    """Two batches of the pose cell's kernels, the driver's bench.* spans,
    host ops and sync calls; with the program's pose6d.* spans inside
    them, or not."""
    names = ["flash_fwd_kernel<16, 2, true, float>",
             "masked_topk_cdist_kernel<5, 4, float>", "merge_splits",
             "consistency_rm_kernel<5, 5, float4>", "sum_segments",
             "masked_topk_cdist_kernel<1, 4, float>",
             "masked_topk_cdist_kernel<1, 4, float>", "elementwise"]
    events, t = [], 0.0
    for b in range(2):
        start = t
        for i, name in enumerate(names):
            events.append(kernel(name, t, 7.0 + i))
            events.append({"ph": "X", "cat": "cpu_op", "name": f"aten::op{i}",
                           "ts": t - 2.0, "dur": 1.5, "tid": 1})
            if i in (3, 6):
                events.append(runtime("cudaStreamSynchronize", t + 8.0))
            t += 12.0 + 3.0 * i
        events.append(ann("bench.ransac", start + 40.0, 60.0))
        events.append(ann("bench.icp", start + 110.0, t - start - 110.0))
        if with_program_spans:
            events.append(ann("pose6d.pose", start - 1.0, t - start + 1.0))
            events.append(ann("pose6d.ransac", start + 41.0, 58.0))
            events.append(ann("pose6d.icp", start + 111.0,
                              t - start - 112.0))
            events.append(ann("pose6d.icp.update", start + 130.0, 15.0))
        t += 20.0
    return events


def run_of(path) -> harness.Run:
    """A traced run whose trace_info the driver's way fills from `path`."""
    t = traces.read_trace(path, KERNEL_GROUPS, 2)
    t["wall_s"] = 1e-3
    t["window_s"] = t["span_s"]
    t["breakdown"] = {"device_ops": t.pop("device_ops"),
                      "idle_gaps": t.pop("idle_gaps")}
    t["n_items"] = 2
    t["host_syncs_per_item"] = t["sync_calls_per_item"] - 1
    t["argmin_coarse_per_item"] = 1
    t["bounds"] = {g: {"least_s": 1e-6, "bound": "ops"} for g in
                   ("flash_fwd", "topk_cdist", "argmin_coarse",
                    "argmin_fine", "rank_major")}
    t["flops_per_item"] = {"model": 1e9, "filter": 1e9, "ransac": 1e9,
                           "icp": 1e9, "trials_per_frame": 1184.0}
    run = harness.Run(cell="orig.pose_b64", config={}, traffic={}, seed=1,
                      trace=True, setup_s=30.0, window_s=51.0,
                      done=[64] * 12, walls_s=[0.39 + 0.001 * i
                                               for i in range(12)],
                      spans={"model": [12.0], "filter": [20.0],
                             "ransac": [277.0], "icp": [64.0]})
    run.trace_info = t
    return run


NEW = ("ransac_live_share", "ransac_idle_ms", "icp_idle_ms",
       "icp_host_syncs_per_batch")


def read_with_trace(monkeypatch, run, path, metrics) -> dict:
    """harness.read_metrics with the annotation readers pointed at
    `path` as the cell's trace."""
    monkeypatch.setattr(annotations, "trace_path", lambda cell: path)
    return harness.read_metrics(run, metrics)


def test_existing_readers_ignore_program_spans(tmp_path, monkeypatch):
    plain_path = write(tmp_path, realistic(False), "plain.json")
    spans_path = write(tmp_path, realistic(True), "spans.json")
    plain, spans = run_of(plain_path), run_of(spans_path)
    spec = harness.load_cell("orig.pose_b64")
    metrics = [m for m in spec["end_to_end"] + spec["per_layer"]
               if m["name"] not in NEW]
    assert len(metrics) >= 16
    a = read_with_trace(monkeypatch, plain, plain_path, metrics)
    b = read_with_trace(monkeypatch, spans, spans_path, metrics)
    assert a == b
    assert {"flash_fwd_roofline", "rank_major_roofline",
            "argmin_cdist_fine_roofline", "host_syncs_per_batch",
            "device_idle_share.pose"} <= set(a)
    for k in ("busy_s", "span_s", "groups", "sync_calls_per_item"):
        assert plain.trace_info[k] == spans.trace_info[k], k
    # the idle gaps are the same time, named by the innermost span
    gap = lambda r: sum(d for _, d in  # noqa: E731
                        r.trace_info["breakdown"]["idle_gaps"])
    assert gap(plain) == pytest.approx(gap(spans))
    assert any(n.startswith("pose6d.") for n, _ in
               spans.trace_info["breakdown"]["idle_gaps"])
    assert not any(n.startswith("pose6d.") for n, _ in
                   plain.trace_info["breakdown"]["idle_gaps"])


def test_span_readers(tmp_path, monkeypatch):
    """ransac_idle_ms, icp_idle_ms and icp_host_syncs_per_batch read
    read_annotations on the cell's trace; a trace without the program's
    spans (the parent's) or a run with no device work gives none."""
    spans_path = write(tmp_path, realistic(True), "spans.json")
    plain_path = write(tmp_path, realistic(False), "plain.json")
    spec = harness.load_cell("orig.pose_b64")
    metrics = [m for m in spec["per_layer"] if m["name"] in NEW[1:]]
    assert len(metrics) == 3
    got = read_with_trace(monkeypatch, run_of(spans_path), spans_path,
                          metrics)
    want = read_annotations(spans_path, ["pose6d.ransac", "pose6d.icp"], 2)
    assert got["ransac_idle_ms"]["value"] == pytest.approx(
        1e3 * want["pose6d.ransac"]["idle_s"])
    assert got["icp_idle_ms"]["value"] == pytest.approx(
        1e3 * want["pose6d.icp"]["idle_s"])
    assert got["icp_host_syncs_per_batch"]["value"] == \
        want["pose6d.icp"]["sync_calls"]
    assert got["ransac_idle_ms"]["value"] > 0
    assert got["icp_host_syncs_per_batch"]["value"] == 1.0
    assert read_with_trace(monkeypatch, run_of(plain_path), plain_path,
                           metrics) == {}
    idle = run_of(spans_path)
    idle.trace_info["busy_s"] = 0.0
    assert read_with_trace(monkeypatch, idle, spans_path, metrics) == {}
    assert read_with_trace(monkeypatch, run_of(spans_path),
                           tmp_path / "absent.json", metrics) == {}


def test_ransac_live_share_reads_the_program_counters(tmp_path):
    """100 x live / all frame blocks the program counted while the
    profiler recorded; none in an untraced run or without counts."""
    import torch

    from pose6d_tpu_torch.utils import profiling
    spec = harness.load_cell("orig.pose_b64")
    metric = [m for m in spec["per_layer"]
              if m["name"] == "ransac_live_share"]
    run = run_of(write(tmp_path, realistic(True)))
    profiling.reset()
    assert harness.read_metrics(run, metric) == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("ransac.frame_blocks", 64 * 8)
        profiling.count("ransac.live_frame_blocks",
                        torch.tensor([8] * 2 + [1] * 62))
    got = harness.read_metrics(run, metric)
    assert got["ransac_live_share"]["value"] == pytest.approx(
        100.0 * 78 / 512)
    untraced = run_of(write(tmp_path, realistic(True)))
    untraced.trace_info = {}
    assert harness.read_metrics(untraced, metric) == {}
    profiling.reset()
