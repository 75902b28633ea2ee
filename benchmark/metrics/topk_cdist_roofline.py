"""Spectral top-5 cdist kernel (csrc/masked_cdist.cu, K = 5): least time
over device time in the profiled batches, %."""
from benchmark.readers import roofline


def read(run):
    return roofline(run, "topk_cdist")
