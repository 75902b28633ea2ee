"""Parameter-tree surgery for warm starts (the part of
pose6d_tpu/models/port_weights.py that the port needs so far).

The reference's torch checkpoint (weights.pt) is not read here: the
port loads flax msgpack files (models/weights.py), and a .pt checkpoint
waits for ROADMAP.md, section 1, item 11.
"""
from __future__ import annotations

import numpy as np


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
