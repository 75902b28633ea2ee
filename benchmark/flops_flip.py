"""Operations of the flip stage (depth-render disambiguation) of one
frame, from shapes, in the units of flops.py's stage counts.

An ICP run on v2 valid cloud points against v1 valid CAD points counts,
as the pose cell's ICP does, 6 operations per (cloud point, CAD point)
distance of each match (the coarse ones against every stride-th CAD
point, the fine ones and the final rmse match against all) and 60 per
cloud point for each weighted rigid update. A render counts 30
operations per posed CAD point (the rotation and translation, the
projection, the cell index and the depth-buffer minimum), the score 12
per coarse cell of each hypothesis, the observed cells one per pixel.
"""
from __future__ import annotations

ICP_MATCH = 6
ICP_UPDATE = 60
SPLAT = 30
SCORE_CELL = 12


def icp(v1: int, v2: int, iters: int, stride: int, fine_iters: int) -> float:
    """One ICP run: iters updates, all but the last fine_iters matched
    against every stride-th CAD point, then the full-resolution rmse."""
    n_fine = iters if stride <= 1 else min(fine_iters, iters)
    coarse = -(-v1 // stride)
    return ((iters - n_fine) * ICP_MATCH * v2 * coarse
            + (n_fine + 1) * ICP_MATCH * v2 * v1 + iters * ICP_UPDATE * v2)


def flip(v1: int, v2: int, n_hyp: int, bank_iters: int, icp_iters: int,
         stride: int, h: int, w: int, render_stride: int) -> dict:
    """The stage's operations by part: the bank ICP (n_hyp runs of
    bank_iters, one at full resolution), the renders and the score, the
    winner's refine (icp_iters - bank_iters, five at full resolution)."""
    cells = (h // render_stride) * (w // render_stride)
    return {"bank": n_hyp * icp(v1, v2, bank_iters, stride, 1),
            "render": n_hyp * (SPLAT * v1 + SCORE_CELL * cells) + h * w,
            "refine": (icp(v1, v2, icp_iters - bank_iters, stride, 5)
                       if icp_iters > bank_iters else 0)}
