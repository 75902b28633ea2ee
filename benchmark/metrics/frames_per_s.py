"""Frames posed in the window over the window (host clock)."""


def read(run):
    return sum(run.done) / run.window_s if run.done else None
