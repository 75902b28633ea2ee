"""Device idle ms a profiled batch inside the program's pose6d.ransac
spans (the gaps between merged device-busy intervals, clipped to the
spans)."""
from benchmark.annotations import of_run


def read(run):
    a = of_run(run, "pose6d.ransac")
    return 1e3 * a["idle_s"] if a else None
