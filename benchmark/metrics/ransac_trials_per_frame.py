"""Mean RANSAC trials per frame of a window batch (the entry's n_trials)."""


def read(run):
    fl = run.trace_info.get("flops_per_item")
    return fl["trials_per_frame"] if fl else None
