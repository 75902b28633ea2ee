"""Operations of a batch (model, filter, RANSAC at its trials, ICP; from
shapes) over the median batch wall and the f32 peak, %."""
from benchmark.readers import mfu


def read(run):
    return mfu(run, ("model", "filter", "ransac", "icp"))
