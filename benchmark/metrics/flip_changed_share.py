"""100 x the frames whose flip winner is not the base hypothesis / the
frames the flip stage ran, over the profiled batches: the program's
counters flip.changed and flip.frames, which it keeps while
torch.profiler records (pose6d_tpu_torch.utils.profiling; nothing to
read in a program without them)."""
from benchmark.program_counters import counter_share


def read(run):
    return counter_share(run, "flip.changed", "flip.frames")
