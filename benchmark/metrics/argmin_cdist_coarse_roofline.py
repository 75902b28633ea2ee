"""ICP argmin cdist kernel on the coarse (every 4th CAD point) calls:
least time over device time in the profiled batches, %."""
from benchmark.readers import roofline


def read(run):
    n = run.trace_info.get("argmin_coarse_per_item", 0)
    return roofline(run, "argmin_cdist", "argmin_coarse",
                    pick=lambda j, per: j < n)
