"""Host-blocking CUDA runtime calls per batch in the profiled batches
(stream, event and device synchronisations, memcpys), less the
harness's own one."""


def read(run):
    if not run.trace_info.get("busy_s"):
        return None
    return run.trace_info["host_syncs_per_item"]
