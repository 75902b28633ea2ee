"""Reading torch.profiler's Chrome trace of a traced window, and the
spans the drivers record around the calls into each layer.

From the trace: the device-busy time (the union of kernel, memcpy and
memset intervals), device time per kernel group (a group is a list of
kernel-name patterns; a helper kernel that a pattern names by "+" joins
the call of the kernel before it), the longest idle gaps named by the
host op running at the gap's start (the innermost annotation and
operator), the device operations that took most time, and the
host-blocking CUDA runtime calls.
"""
from __future__ import annotations

import json
import re
import time
from contextlib import contextmanager
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


class Spans:
    """Per-batch spans: CUDA events and the host clock around each call
    into a layer, read once the window has closed."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.pending = []                     # (name, host_ms, ev0, ev1)

    @contextmanager
    def __call__(self, name: str):
        import torch
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        host_ms = 1e3 * (time.perf_counter() - t0)
        if ev is not None:
            ev[1].record()
        self.pending.append((name, host_ms, ev))

    def collect(self) -> dict:
        """{name: [device ms (CUDA events) or host ms, ...]}, and
        {name + ".host": [host ms, ...]}."""
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        out: dict = {}
        for name, host_ms, ev in self.pending:
            out.setdefault(name + ".host", []).append(host_ms)
            out.setdefault(name, []).append(
                ev[0].elapsed_time(ev[1]) if ev is not None else host_ms)
        self.pending.clear()
        return out


def profile(run, root: Path, groups: dict, n: int, item, cuda: bool,
            extra) -> None:
    """Run item(j) for j < n under torch.profiler, after every timed
    item; write the Chrome trace and the spans under build/benchmark/ of
    the checkout, and fill run.trace_info: read_trace's numbers, the
    same items' unprofiled wall (the window's median), breakdown, and
    extra(outputs of the items), which adds the driver's own."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with torch.profiler.profile(activities=acts) as prof:
        outs = [item(j) for j in range(n)]
    out_dir = Path(root) / "build" / "benchmark"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{run.cell}.trace.json"
    prof.export_chrome_trace(str(path))
    t = read_trace(path, groups, n)
    t["wall_s"] = statistics.median(run.walls_s) * n
    t["window_s"] = t["span_s"]
    t["breakdown"] = {"device_ops": t.pop("device_ops"),
                      "idle_gaps": t.pop("idle_gaps")}
    t["n_items"] = n
    t.update(extra(outs))
    run.trace_info = t
    (out_dir / f"{run.cell}.spans.json").write_text(json.dumps(
        {"spans": run.spans,
         "trace": {k: v for k, v in t.items() if k != "groups"}}))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(path: Path, groups: dict, n_items: int) -> dict:
    """The numbers of a Chrome trace (µs) of `n_items` batches or steps.

    groups: {group: [pattern, ...]}: a kernel belongs to the first group
    one of whose patterns it contains; a pattern that starts with "+"
    names a helper kernel that belongs to the call of the kernel before
    it. Returns busy_s, span_s (first to last device op), per-group
    device_s and calls (a list of each call's seconds, in order),
    device_ops, idle_gaps, sync_calls_per_item."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    dev.sort(key=lambda e: e["ts"])
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    calls = {g: [] for g in groups}
    last = None
    for e in dev:
        if e.get("cat") != "kernel":
            continue
        hit = None
        for g, pats in groups.items():
            for p in pats:
                if p.startswith("+"):
                    if p[1:] in e["name"] and last == g:
                        calls[g][-1] += e["dur"]
                        hit = "helper"
                        break
                elif re.search(p, e["name"]):
                    calls[g].append(e["dur"])
                    hit = g
                    break
            if hit:
                break
        if hit != "helper":
            last = hit
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation",
                                 "cuda_runtime")]
    host.sort(key=lambda h: h["ts"])
    gaps: dict = {}
    active, nxt = [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        while nxt < len(host) and host[nxt]["ts"] <= e0:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h["ts"] + h["dur"] > e0]
        anns = [h for h in active if h["cat"] == "user_annotation"]
        ops = [h for h in active if h["cat"] != "user_annotation"]
        ann = (min(anns, key=lambda h: h["dur"])["name"] if anns
               else "outside annotations")
        op = min(ops, key=lambda h: h["dur"])["name"] if ops else "no host op"
        key = f"{ann} / {op}"
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0)
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") in SYNC_CALLS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "span_s": (busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0,
        "groups": {g: {"device_s": sum(c) * 1e-6, "calls": c}
                   for g, c in calls.items()},
        "device_ops": [[n[:120], d * 1e-6] for n, d in top],
        "idle_gaps": [[n[:120], d * 1e-6] for n, d in top_gaps],
        "sync_calls_per_item": syncs / max(n_items, 1),
    }
