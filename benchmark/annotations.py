"""Device idle time and host-blocking calls inside the program's own
spans, read from torch.profiler's Chrome trace.

The port's spans (pose6d_tpu_torch/utils/profiling.py, "pose6d.<name>")
are user annotations on the trace's clock. For each annotation name the
union of its intervals is taken (a span nested in another of the same
name counts once); its idle time is the part of the gaps between merged
device-busy intervals (kernels, memcpy, memset, as traces.read_trace
merges them) that lies inside the union, and its sync calls are the
host-blocking CUDA runtime calls (traces.SYNC_CALLS) that start inside
it.

A traced run's readers (metrics/ransac_idle_ms.py and the others) read
the trace that traces.profile wrote for the cell under build/benchmark/
of the checkout; a trace without the program's spans (a program that
has none) gives them nothing to read.
"""
from __future__ import annotations

import json
from pathlib import Path

from .traces import DEVICE_CATS, SYNC_CALLS, _merge

ROOT = Path(__file__).resolve().parents[1]


def _overlap(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by sorted disjoint `intervals`."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals
               if s < hi and e > lo)


def read_annotations(path: Path, names, n_items: int) -> dict:
    """{name: {"idle_s", "sync_calls", "span_s", "count"}}, the first three
    per item (summed over the trace, divided by n_items), for each name in
    `names` that the trace holds as an annotation."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    syncs = sorted(e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") in SYNC_CALLS)
    n = max(n_items, 1)
    out = {}
    for name in names:
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                 and e.get("name") == name]
        if not spans:
            continue
        union = _merge(spans)
        idle = sum(_overlap(gaps, s, e) for s, e in union)
        calls = sum(1 for t in syncs if any(s <= t < e for s, e in union))
        out[name] = {"idle_s": idle * 1e-6 / n, "sync_calls": calls / n,
                     "span_s": sum(e - s for s, e in union) * 1e-6 / n,
                     "count": len(spans)}
    return out


def trace_path(cell: str) -> Path:
    """Where traces.profile writes a cell's Chrome trace."""
    return ROOT / "build" / "benchmark" / f"{cell}.trace.json"


def of_run(run, name: str):
    """read_annotations' numbers for annotation `name` in a traced run's
    profiled batches, or None where the run profiled no device work or
    its trace holds no such annotation."""
    n = run.trace_info.get("n_items")
    path = trace_path(run.cell)
    if not n or not run.trace_info.get("busy_s") or not path.exists():
        return None
    return read_annotations(path, [name], n).get(name)
