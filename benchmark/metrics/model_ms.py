"""Median device ms of the model span per batch (CUDA events around
the call)."""
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, "model")
