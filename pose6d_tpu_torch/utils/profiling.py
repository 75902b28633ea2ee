"""Profiling helpers (port of pose6d_tpu/utils/profiling.py): a
torch.profiler trace and wall-clock stage timers.

    with profile_trace("/tmp/trace"):      # trace.json: chrome://tracing
        run_step(...)

    timer = StageTimer()
    with timer("forward", sync_value=out):
        out = fwd(batch)
    print(timer.summary())
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where the card is
    there), written as <log_dir>/trace.json in the Chrome trace format."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StageTimer:
    """Wall-clock stage timing; a stage given a tensor (or any value
    holding CUDA tensors) synchronises the card before it stops."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if sync_value is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {k: {"mean_ms": 1e3 * sum(v) / len(v), "n": len(v)}
                for k, v in self.times.items()}
