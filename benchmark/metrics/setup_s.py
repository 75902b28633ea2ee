"""Seconds from process start to the end of warm-up (host clock)."""


def read(run):
    return run.setup_s
