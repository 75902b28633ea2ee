"""Host-blocking CUDA runtime calls (traces.SYNC_CALLS) a profiled batch
that start inside the program's pose6d.icp spans."""
from benchmark.annotations import of_run


def read(run):
    a = of_run(run, "pose6d.icp")
    return a["sync_calls"] if a else None
