"""Rank-major consistency kernel (csrc/consistency_rank_major.cu): least
time over device time of its calls in the profiled batches, %."""
from benchmark.readers import roofline


def read(run):
    return roofline(run, "rank_major")
