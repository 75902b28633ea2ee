"""Process groups and process-sharded frame lists (port of
pose6d_tpu/parallel/multihost.py).

One process per card over torch.distributed. init_multihost brings up the
default process group from a coordinator address; evaluate() gives each
process a strided shard of its frame list (shard_frame_list) and sums
the per-object IR accumulators across processes at the end
(allreduce_metric_sums). Frames are independent, so the group carries
only the rendezvous and those final sums. Without a group the partition
is the identity and the sum a copy.

Collectives go through the rank's card under NCCL (it takes no CPU
tensor) and through the CPU under gloo (which cannot all-gather CUDA
tensors); collective_device() says which. gloo is also what puts two
ranks on one card: NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import datetime
import os
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

# a missing peer fails the rendezvous or a collective after this long
TIMEOUT_S = 900


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_group(init_method: str, world_size: int, rank: int,
               backend: str | None = None) -> None:
    """torch.distributed.init_process_group with a finite timeout; under
    NCCL this process's card (rank % visible cards) becomes the current
    device first, as resolve_device() picks it."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> None:
    """Join the process group whose rendezvous is tcp://`coordinator`
    (host:port of process 0). No-op without a coordinator or when a group
    is already up. backend: "nccl" (the default when CUDA is available)
    or "gloo" (the default on the CPU)."""
    if coordinator is None or in_group():
        return
    missing = [flag for flag, v in (("--num-processes", num_processes),
                                    ("--process-id", process_id))
               if v is None]
    if missing:
        raise ValueError(f"--coordinator {coordinator} needs "
                         f"{' and '.join(missing)}")
    init_group(f"tcp://{coordinator}", num_processes, process_id, backend)


def shard_frame_list(n_frames: int, process_index: int | None = None,
                     process_count: int | None = None) -> np.ndarray:
    """Strided partition of frame indices for this process.

    Strided (rather than contiguous blocks) so BOP scene ordering, which
    correlates with object id and scene difficulty, spreads evenly
    across processes."""
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    return np.arange(pi, n_frames, pc)


def collective_device() -> torch.device:
    """Where a collective of the default group takes its tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The element-wise sum of `t` over the group's processes, on t's
    device (in place when t is already on the collective device)."""
    buf = t.to(collective_device())
    dist.all_reduce(buf)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (one shape on all) concatenated along dim 0
    in process order, on t's device."""
    buf = t.contiguous().to(collective_device())
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(t.device)


def broadcast_object(obj):
    """Process 0's `obj` (picklable) on every process."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def allreduce_metric_sums(local_sums: dict[str, np.ndarray]) -> dict:
    """Sum per-object metric accumulators across processes.

    local_sums maps metric name -> array (e.g. per-object IR sums and
    counts), one shape per name on every process. Single-process it is
    the identity (dtype kept). Otherwise the JAX package's arithmetic:
    each array cast to float32, every process's copy gathered, and the
    copies summed over the process axis in process order on the host
    (a float32 result). Call once, on every process."""
    if rank_and_world()[1] == 1:
        return {k: np.asarray(v) for k, v in local_sums.items()}
    out = {}
    for k in sorted(local_sums):        # one collective order everywhere
        local = torch.as_tensor(np.asarray(local_sums[k], np.float32))
        rows = all_gather_rows(local[None]).cpu().numpy()
        out[k] = np.sum(rows, axis=0)
    return out


@contextmanager
def worker_threads(n_workers: int):
    """The host's cores split between `n_workers` spawned processes:
    their BLAS and torch thread pools read these variables when they
    load, so the variables hold while the workers start."""
    names = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: str(max(1, (os.cpu_count() or 1) // n_workers))
                       for k in names})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
