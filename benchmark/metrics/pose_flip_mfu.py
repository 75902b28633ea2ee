"""Operations of a batch (model, filter, RANSAC at its trials, ICP, and
the flip stage's bank ICP, renders, score and refine; from shapes,
flops.py and flops_flip.py) over the median batch wall and the f32
peak, %."""
from benchmark.readers import mfu


def read(run):
    return mfu(run, ("model", "filter", "ransac", "icp", "flip"))
