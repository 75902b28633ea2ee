"""Device idle ms a profiled batch inside the program's pose6d.flip spans
(the gaps between merged device-busy intervals, clipped to the spans;
nothing to read in a program without them)."""
from benchmark.annotations import of_run


def read(run):
    a = of_run(run, "pose6d.flip")
    return 1e3 * a["idle_s"] if a else None
