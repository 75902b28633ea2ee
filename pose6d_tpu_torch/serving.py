"""Serving export: the online depth -> pose frame as one torch.export
artifact (port of pose6d_tpu/serving.py).

The whole per-instance frame (backprojection -> outlier removal -> FPS
-> on-device graph Laplacian and LOBPCG -> DPFMNet -> spatial filter ->
RANSAC -> ICP -> flip disambiguation) is Predictor._frame, the function
a live Predictor.predict request runs. export_predictor traces it with
torch.export into one program: the weights and the object's padded CAD
operators, diameter, flip bank and LOBPCG start block become the
program's state, as the JAX package bakes them in as constants; the
hand-written kernels are the pose6d_tpu_torch ops, one node each; the
data-dependent loops (LOBPCG's stop rule, RANSAC's adaptive exit, the
FPS chain) are while_loop nodes; ICP's and the flip stage's fixed
counts are unrolled, as lax.scan is. The artifact replays on a host
with torch and the port's op registrations (pose6d_tpu_torch.ops.
kernels, whose CUDA kernels build from csrc/ at first use): no model,
solver or API module.

    pred = Predictor(model, {5: cad_ops})                 # on cuda
    blob = export_predictor(pred, obj_id=5, depth_shape=(480, 640))
    Path("pose_obj5.pt2").write_bytes(blob)
    # ... on the serving host:
    fn = load_exported(Path("pose_obj5.pt2").read_bytes())   # on cuda
    u = ransac_uniforms(131072, seed=0, device="cuda")
    out = fn(depth, K, cam_scale, mask, u)    # {"R", "t", ...}

The RANSAC draws are an input (uniforms (n_blocks, block, 3) in [0, 1),
block = min(HYP_BLOCK, n_hypotheses)), as the JAX artifact takes its
PRNG key: the same draws give the live request's bits on one device.
An artifact exported on the CPU runs on the card after
load_exported(blob) (device="cuda", the default): the ops pick their CUDA kernels
from the tensors' device at run time, so no backend is pinned at trace
time (the JAX package's artifact pins its attention path then).
"""
from __future__ import annotations

import io

import torch

from .ops import kernels  # noqa: F401  (registers the ops the artifact calls)

HYP_BLOCK = 512      # solvers/candidates.HYP_BLOCK: hypotheses per block
OUTPUTS = ("R", "t", "n_inliers", "icp_rmse", "overlap21", "flip_hypothesis")


class _Frame(torch.nn.Module):
    """Predictor._frame for one object, its tensors held as buffers."""

    def __init__(self, pred, obj_id: int):
        super().__init__()
        self.model = pred.model
        self.pred = pred
        state = pred._object(int(obj_id))
        self.cad_keys = tuple(state["cad"])
        for k, v in state["cad"].items():
            self.register_buffer(f"cad_{k}", v.clone())
        self.register_buffer("diam", state["diam"])
        self.register_buffer("x0", state["x0"])
        self.register_buffer("sym_rots", state.get("sym_rots"))

    def forward(self, depth, K, cam_scale, mask, uniforms):
        state = {"cad": {k: getattr(self, f"cad_{k}") for k in self.cad_keys},
                 "diam": self.diam, "x0": self.x0, "sym_rots": self.sym_rots}
        out = self.pred._frame(state, depth, K, cam_scale, mask, uniforms)
        return {k: out[k][0] for k in OUTPUTS if k in out}


def draw_shape(n_hypotheses: int) -> tuple[int, int, int]:
    """(n_blocks, block, 3): the RANSAC draws of one frame."""
    block = min(HYP_BLOCK, n_hypotheses)
    return -(-n_hypotheses // block), block, 3


def ransac_uniforms(n_hypotheses: int, seed: int = 0, device="cuda"):
    """One frame's RANSAC draws, uniform in [0, 1), from a generator on
    `device` seeded with `seed`, for callers with no draws of their own."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(draw_shape(n_hypotheses), generator=gen, device=device)


def export_predictor(pred, obj_id: int, depth_shape: tuple[int, int]) -> bytes:
    """Serialize the frame of object `obj_id` for depth images of the
    static shape (H, W). pred: an online-mode api.Predictor; the program
    runs on its device. Inputs: depth (H, W) f32 raw units, K (3, 3)
    f32, cam_scale () f32 (1000 / depth_scale), mask (H, W) bool,
    uniforms draw_shape(n_hypotheses) f32. Outputs: R (3, 3), t (3,),
    n_inliers, icp_rmse, overlap21 (v_pc,) and, with disambiguation,
    flip_hypothesis."""
    if pred.mode != "online":
        raise ValueError("cached mode is host-mediated: export targets the "
                         "self-contained online frame")
    h, w = depth_shape
    dev = pred.device
    args = (torch.zeros((h, w), dtype=torch.float32, device=dev),
            torch.eye(3, dtype=torch.float32, device=dev),
            torch.ones((), dtype=torch.float32, device=dev),
            torch.zeros((h, w), dtype=torch.bool, device=dev),
            torch.zeros(draw_shape(pred._rh), dtype=torch.float32,
                        device=dev))
    with torch.no_grad():
        program = torch.export.export(_Frame(pred, obj_id), args,
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes, device="cuda"):
    """The artifact's callable (depth, K, cam_scale, mask, uniforms) ->
    {"R", "t", ...} on `device` (the card unless the caller asks for the
    CPU; raises when CUDA is asked for and missing): the program's state
    and the devices its graph names move there, so an artifact exported
    on either device runs on either."""
    from torch.export.passes import move_to_device_pass

    from .runtime import resolve_device
    device = resolve_device(device)
    program = move_to_device_pass(torch.export.load(io.BytesIO(blob)),
                                  device)
    module = program.module()

    def run(depth, K, cam_scale, mask, uniforms) -> dict:
        with torch.inference_mode():
            return module(depth, K, cam_scale, mask, uniforms)

    return run


__all__ = ["HYP_BLOCK", "OUTPUTS", "draw_shape", "export_predictor",
           "load_exported", "ransac_uniforms"]
