"""Operations and bytes of each kernel call and each stage, from shapes,
against one H100's published peaks (NVIDIA data sheet, SXM, dense).

Bytes count each input read once and each output written once;
operations count what these inputs need (valid keys, valid columns,
pairs still alive in a pruning round), as chip_smoke.py's kernel table
counts them. A roofline share is least time / measured time, the least
time being the larger of bytes / HBM bandwidth and operations / the
float32 peak of the CUDA cores, which every kernel of the cells runs
on.
"""
from __future__ import annotations

PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12    # B/s, HBM3


def least_s(n_bytes: float, f32_flops: float = 0.0) -> float:
    return max(n_bytes / PEAK_BYTES, f32_flops / PEAK_F32)


def bound_by(n_bytes: float, f32_flops: float = 0.0) -> str:
    return ("bytes" if n_bytes / PEAK_BYTES >= f32_flops / PEAK_F32
            else "operations")


# -- kernel calls (one frame; sum over the batch) --------------------------

def flash_fwd(n: int, m: int, m_valid: int, heads: int, dim: int) -> dict:
    """One masked cross-attention forward of n queries over m keys (m_valid
    valid): q, out (n), k, v (m) of heads x dim floats, the key mask; QK
    and PV, 2 x dim FMAs each per (query, valid key, head)."""
    tok = heads * dim
    return {"bytes": 4 * tok * (2 * n + 2 * m) + m,
            "f32": 4 * dim * heads * n * m_valid}


def cdist(n: int, m: int, m_valid: int, c: int, k: int) -> dict:
    """Masked top-k (or argmin, k = 1) of n rows over m columns of c
    features: both read, the mask read, (d2, index) of k written; a
    dot product (2 c) per (row, valid column)."""
    return {"bytes": 4 * (n * c + m * c) + m + 8 * n * k,
            "f32": 2 * c * n * m_valid}


def rank_major(p: int, v2: int, live_rows: int) -> dict:
    """One rank-major consistency sum over p = k * v2 pairs: CAD points
    (3 floats), weights, the (v2, v2) PC distance table read, sums
    written; 12 operations per (live row, column)."""
    return {"bytes": 4 * (3 * p + p + v2 * v2 + p),
            "f32": 12 * live_rows * p}


# -- stages (one frame) ----------------------------------------------------

def dense(rows: int, c_in: int, c_out: int) -> int:
    return 2 * rows * c_in * c_out + rows * c_out


def dpfm_forward(v1: int, v2: int, k_eig: int, n_fmap: int, c_in: int,
                 width: int = 64, n_blocks: int = 2, n_feat: int = 32,
                 gnn: int = 32, heads: int = 2, ov: int = 32,
                 n_hks: int = 0) -> float:
    """Floating-point operations of one DPFMNet forward on v1 valid CAD
    and v2 valid PC points (matrix products and the attention; the
    elementwise work is small beside them)."""
    total = 0.0
    for v in (v1, v2):
        if n_hks:
            total += 2 * v * k_eig * n_hks + 2 * n_hks * k_eig
        total += dense(v, c_in, width)
        for _ in range(n_blocks):
            total += 4 * v * k_eig * width            # to / from the basis
            total += dense(v, 2 * width, width) + 2 * dense(v, width, width)
        total += dense(v, width, n_feat)
        total += dense(v, n_feat, gnn)               # refiner first_lin
        total += dense(v, gnn, ov) + dense(v, ov, 1)  # overlap head
        total += dense(v, gnn, n_feat)               # refiner last_lin
    dim = gnn // heads
    for nq, nk in ((v1, v2), (v2, v1)):              # the two directions
        total += dense(nq, gnn, gnn) + 2 * dense(nk, gnn, gnn)  # q, k, v
        total += 4 * dim * heads * nq * nk            # scores and P V
        total += dense(nq, gnn, gnn)                  # merge
        total += dense(nq, 2 * gnn, 2 * gnn) + dense(nq, 2 * gnn, gnn)
    k = n_fmap
    total += 2 * (2 * k * (v1 + v2) * n_feat)         # A, B
    total += 2 * (2 * k * k * n_feat)                 # A A^T, B A^T
    total += k * (2 / 3 * k ** 3 + 2 * k * k)         # k solves of k x k
    return total


def ransac(n_valid_pairs: int, trials: int, refits: int = 2) -> float:
    """Hypotheses scored: per trial a closed-form triad (~150 operations)
    and, per valid pair, a rotated and translated point, its squared
    residual and the threshold (~22); the refits (~60 per pair each)."""
    return trials * (150 + 22 * n_valid_pairs) + refits * 60 * n_valid_pairs
