"""The arithmetic the reference computes in.

"f64": float64 throughout, the reference proper. "f32": float32 with
exact float32 products. "tf32": float32 whose matrix products take their
operands rounded to TF32 (10 explicit mantissa bits, round to nearest,
ties away from zero, as cvt.rna.tf32.f32 rounds them) and accumulate in
float32, as a tensor-core TF32 product does. "tf32" is the control: the
precision just below the float32 that the configurations state, and the
step a later change might take. Emulating the rounding, rather than
switching torch.backends.cuda.matmul.allow_tf32 on, makes the control
the same on every device and independent of which products cuBLAS
chooses to run on tensor cores.
"""
from __future__ import annotations

import torch

NAMES = ("f64", "f32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (kept in float32 storage)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2**31, dtype=torch.int32, device=x.device)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | sign).view(torch.float32)


class Prec:
    def __init__(self, name: str):
        if name not in NAMES:
            raise ValueError(f"precision must be one of {NAMES}: {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def cast(self, x):
        x = torch.as_tensor(x)
        return x.to(self.dtype) if x.is_floating_point() else x

    def mm(self, a, b):
        """a @ b with this precision's products."""
        if self.name == "tf32":
            return to_tf32(a) @ to_tf32(b)
        return a @ b
