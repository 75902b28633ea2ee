"""Process-level runtime setup shared by the port's entry points.

Counterpart of pose6d_tpu/runtime.py. The pipeline wants f32 semantics
for geometry and linear algebra, so TF32 is switched off for both
matrix products and cuDNN convolutions.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def configure() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and missing (the port never carries on on the CPU by itself).

    Inside a torch.distributed process group a bare "cuda" is this
    process's card, cuda:{rank % visible cards}, which also becomes the
    current device (one process per card; two ranks share a card only
    when there are fewer cards). Without a group it stays "cuda"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type == "cuda" and device.index is None \
            and dist.is_available() and dist.is_initialized():
        device = torch.device(
            "cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    configure()
    return device
