"""100 x the frame blocks RANSAC scored for frames still drawing / all
the frame blocks it scored, over the profiled batches: the program's
counters ransac.live_frame_blocks and ransac.frame_blocks, which it
keeps while torch.profiler records (pose6d_tpu_torch.utils.profiling;
nothing to read in a program without them)."""


def read(run):
    if not run.trace_info.get("n_items"):
        return None
    try:
        from pose6d_tpu_torch.utils.profiling import collect
    except ImportError:
        return None
    c = collect()["counters"]
    if not c.get("ransac.frame_blocks"):
        return None
    return 100.0 * c["ransac.live_frame_blocks"] / c["ransac.frame_blocks"]
