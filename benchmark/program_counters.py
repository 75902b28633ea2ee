"""The program's own counters (pose6d_tpu_torch/utils/profiling.py),
which it keeps while torch.profiler records and sums at collect(): a
traced run's readers take them after its profiled batches."""
from __future__ import annotations


def counter_share(run, part: str, whole: str):
    """100 x counter `part` / counter `whole`, or None where the run
    profiled nothing or the program keeps no such counters."""
    if not run.trace_info.get("n_items"):
        return None
    try:
        from pose6d_tpu_torch.utils.profiling import collect
    except ImportError:
        return None
    c = collect()["counters"]
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
