"""Median device ms of the flip span per batch: CUDA events the driver
records on the stream around its call of disambiguate_pose_depth."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "flip")
