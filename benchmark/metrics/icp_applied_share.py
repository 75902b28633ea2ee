"""100 x the ICP updates that were taken (at least 3 gated pairs) / all
the frame updates ICP ran, over the profiled batches: the program's
counters icp.applied_updates and icp.frame_updates (nothing to read in a
program without them)."""
from benchmark.program_counters import counter_share


def read(run):
    return counter_share(run, "icp.applied_updates", "icp.frame_updates")
