"""The reference's torch checkpoint as the port's parameters, and
parameter-tree surgery for warm starts (port of
pose6d_tpu/models/port_weights.py).

The reference ships weights/weights.pt, a torch state dict of its own
module names (feature_extractor.block_{b}.mlp.miniMLP_mlp_layer_{i:03d},
feat_refiner.layers.{i}.attn.proj.{0,1,2}, 1x1 Conv1d weights
(out, in, 1), ...). port_reference_checkpoint maps every tensor into the
flax params tree that both packages read (models/weights.py): a Linear
weight (out, in) becomes a Dense kernel (in, out); a 1x1 Conv1d weight
drops its kernel axis first.
"""
from __future__ import annotations

import numpy as np


def _lin(sd, key):
    w = np.asarray(sd[f"{key}.weight"], np.float32)
    b = np.asarray(sd[f"{key}.bias"], np.float32)
    if w.ndim == 3:  # Conv1d kernel_size=1: (out, in, 1)
        w = w[:, :, 0]
    return {"kernel": np.ascontiguousarray(w.T), "bias": b}


def port_reference_checkpoint(state_dict) -> dict:
    """The reference's state dict (torch tensors or arrays) -> a flax
    {"params": tree} of float32 numpy arrays for DPFMNet. A missing key
    raises KeyError naming it."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
              else np.asarray(v)) for k, v in state_dict.items()}

    fe = {"first_lin": _lin(sd, "feature_extractor.first_lin"),
          "last_lin": _lin(sd, "feature_extractor.last_lin")}
    for b in (0, 1):
        blk = {"diffusion_time": np.asarray(
            sd[f"feature_extractor.block_{b}.diffusion.diffusion_time"],
            np.float32)}
        blk["mlp"] = {f"layer_{i:03d}": _lin(
            sd, f"feature_extractor.block_{b}.mlp.miniMLP_mlp_layer_{i:03d}")
            for i in range(3)}
        fe[f"block_{b}"] = blk

    fr = {"first_lin": _lin(sd, "feat_refiner.first_lin"),
          "last_lin": _lin(sd, "feat_refiner.last_lin")}
    li = 0
    while f"feat_refiner.layers.{li}.attn.merge.weight" in sd:
        base = f"feat_refiner.layers.{li}"
        attn = {
            # the reference's projection order: 0 = query, 1 = key,
            # 2 = value
            "proj_q": _lin(sd, f"{base}.attn.proj.0"),
            "proj_k": _lin(sd, f"{base}.attn.proj.1"),
            "proj_v": _lin(sd, f"{base}.attn.proj.2"),
            "merge": _lin(sd, f"{base}.attn.merge"),
        }
        # the reference's MLP Sequential: 0 = conv, 1 = InstanceNorm,
        # 2 = ReLU, 3 = conv
        mlp = {"lin_0": _lin(sd, f"{base}.mlp.0"),
               "lin_1": _lin(sd, f"{base}.mlp.3")}
        fr[f"layer_{li}"] = {"attn": attn, "mlp": mlp}
        li += 1
    fr["overlap"] = {
        "lin0": _lin(sd, "feat_refiner.overlap_predictor.overlap_score_net.0"),
        "lin1": _lin(sd, "feat_refiner.overlap_predictor.overlap_score_net.2"),
    }
    return {"params": {"feature_extractor": fe, "feat_refiner": fr}}


def load_reference_checkpoint(path) -> dict:
    """Read weights.pt (tensors only, on the CPU) and port it."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return port_reference_checkpoint(sd)


def extend_first_lin_input(params: dict, extra_in: int) -> dict:
    """Widen the encoder's first_lin input by `extra_in` zero rows.

    params is a {"params": tree} of numpy arrays (flax layout: first_lin's
    kernel is (c_in, width)). Makes an xyz-trained tree a function-
    preserving warm start for an input_features="xyz_hks" model: the
    appended channels contribute exactly 0, so the widened model computes
    the xyz model's function until training moves those rows.
    """
    out = dict(params)
    p = dict(out["params"])
    fe = dict(p["feature_extractor"])
    fl = dict(fe["first_lin"])
    k = np.asarray(fl["kernel"])                      # (c_in, width)
    fl["kernel"] = np.concatenate(
        [k, np.zeros((extra_in, k.shape[1]), k.dtype)], axis=0)
    fe["first_lin"] = fl
    p["feature_extractor"] = fe
    out["params"] = p
    return out
