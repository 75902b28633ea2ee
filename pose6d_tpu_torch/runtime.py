"""Process-level runtime setup shared by the port's entry points.

Counterpart of pose6d_tpu/runtime.py. The pipeline wants f32 semantics
for geometry and linear algebra, so TF32 is switched off for both
matrix products and cuDNN convolutions.
"""
from __future__ import annotations

import torch


def configure() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and missing (the port never carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    configure()
    return device
