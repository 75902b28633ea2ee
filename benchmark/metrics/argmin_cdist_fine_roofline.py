"""ICP argmin cdist kernel on the full-resolution calls (the last
iterations and the rmse): least time over device time, %."""
from benchmark.readers import roofline


def read(run):
    n = run.trace_info.get("argmin_coarse_per_item", 0)
    return roofline(run, "argmin_cdist", "argmin_fine",
                    pick=lambda j, per: j >= n)
