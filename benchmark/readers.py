"""Helpers of the metric readers (metrics/<name>.py): each reader returns
a number, or None where the run has nothing to read."""
from __future__ import annotations

import statistics

from . import flops


def span_ms(run, name: str):
    """Median over the window's batches or steps of a span's device ms."""
    values = run.spans.get(name)
    return statistics.median(values) if values else None


def roofline(run, group: str, bound_key: str | None = None, pick=None):
    """Least time / device time of a kernel group's calls in the profiled
    batches or steps, in %. pick(j, calls_per_item) selects calls."""
    info = run.trace_info
    g = info.get("groups", {}).get(group)
    bound = info.get("bounds", {}).get(bound_key or group)
    if not g or not bound or not g["calls"]:
        return None
    calls = g["calls"]
    if pick is not None:
        per = len(calls) // info["n_items"]
        calls = [c for j, c in enumerate(calls) if pick(j % per, per)]
    device_s = sum(calls) * 1e-6
    return 100.0 * bound["least_s"] / device_s if device_s > 0 else None


def idle_share(run):
    """1 - device-busy time / the same batches' unprofiled wall, in %."""
    info = run.trace_info
    if not info.get("busy_s") or not info.get("wall_s"):
        return None
    return 100.0 * (1.0 - info["busy_s"] / info["wall_s"])


def mfu(run, stages):
    """Operations of one batch or step over its median wall time and the
    f32 peak, in %."""
    fl = run.trace_info.get("flops_per_item")
    if not fl or not run.walls_s:
        return None
    wall = statistics.median(run.walls_s)
    return 100.0 * sum(fl[s] for s in stages) / (wall * flops.PEAK_F32)
