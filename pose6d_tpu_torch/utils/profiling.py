"""Profiling of the port (port of pose6d_tpu/utils/profiling.py): a
torch.profiler trace, and the program's own spans and counters.

    with profile_trace("/tmp/trace"):      # trace.json: chrome://tracing
        run_step(...)                      # counters.json beside it

Spans and counters are on while torch.profiler records (and torch.export
is not tracing, so an exported program is the same either way); at
other times a span or a count costs one check and does nothing.
`span(name)` is the profiler annotation "pose6d.<name>", so the trace
carries the program's spans on its own clock; `count(name, value)` adds
a host number, or keeps a reference to a tensor the program has
computed, which `collect()` sums once the work is done (no read of the
card on the hot path).

Spans: pose (solvers/candidates.candidate_select_pose), model
(models/dpfm.DPFMNet.forward), filter
(solvers/fmap2pointmap.spatial_filtering_fmap2pointmap), ransac,
ransac.block, ransac.refit (solvers/ransac.ransac_pose), icp, icp.match,
icp.update (solvers/icp.icp_point2point), flip, flip.bank, flip.score,
flip.refine (solvers/multistart.disambiguate_pose_depth). Counters:
ransac.frame_blocks (frames x blocks the loop ran),
ransac.live_frame_blocks (the blocks each frame ran while it still
drew), icp.frame_updates (frames x the ICP iterations run),
icp.applied_updates (the updates taken: at least 3 gated pairs),
flip.frames, flip.changed (frames whose winner is not the base
hypothesis), flip.bank_rows (frames x hypotheses), flip.live_bank_rows
(the bank rows that are not an identity pad after row 0).
"""
from __future__ import annotations

import contextlib
import functools
import json
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler

PREFIX = "pose6d."
_OFF = contextlib.nullcontext()
_COUNTS: dict = {}               # name -> host int
_REFS: dict = {}                 # name -> [tensor, ...]
_LAUNCHES0: dict = {}            # ops/kernels LAUNCHES at the last reset()


def _on() -> bool:
    """The one check: torch.profiler records and torch.export does not
    trace."""
    return (_profiler._is_profiler_enabled
            and not torch.compiler.is_exporting())


def counting() -> bool:
    """Whether spans and counters are on: for a counter whose value costs
    work to compute, which the caller then computes only when asked."""
    return _on()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where the card is
    there), written as <log_dir>/trace.json in the Chrome trace format
    with the program's spans, and the block's counters and kernel
    launches (collect()) as <log_dir>/counters.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "counters.json").write_text(json.dumps(collect(), indent=1))


def span(name: str):
    """A context manager: the annotation "pose6d.<name>" while the
    profiler records, nothing otherwise."""
    if not _on():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: each call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value) -> None:
    """Add `value` to counter `name` while the profiler records: an int
    now, a tensor (its sum) at collect()."""
    if not _on():
        return
    if isinstance(value, torch.Tensor):
        _REFS.setdefault(name, []).append(value)
    else:
        _COUNTS[name] = _COUNTS.get(name, 0) + value


def _launches() -> dict:
    from ..ops.kernels._build import LAUNCHES
    return dict(LAUNCHES)


def reset() -> None:
    """Zero the counters and start the launch count anew."""
    global _LAUNCHES0
    _COUNTS.clear()
    _REFS.clear()
    _LAUNCHES0 = _launches()


def collect() -> dict:
    """Since the last reset() (or the process's start): the counters
    {name: int} (the tensors' sums read here) and the kernel launches
    {kernel: calls} (ops/kernels LAUNCHES)."""
    counters = dict(_COUNTS)
    for name, refs in _REFS.items():
        counters[name] = counters.get(name, 0) + sum(int(t.sum())
                                                     for t in refs)
    return {"counters": counters,
            "launches": {k: v - _LAUNCHES0.get(k, 0)
                         for k, v in _launches().items()}}
