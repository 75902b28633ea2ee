"""1 - device-busy time (profiler) / the unprofiled batch wall, %."""
from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
