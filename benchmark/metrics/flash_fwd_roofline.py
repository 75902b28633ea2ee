"""Flash forward kernels (csrc/flash_cross_attention.cu): least time over
device time of their calls in the profiled batches, %."""
from benchmark.readers import roofline


def read(run):
    return roofline(run, "flash_fwd")
