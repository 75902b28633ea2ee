"""ICP's update (kernel: csrc/icp_kabsch_update.cu).

Replaces no TPU kernel: the JAX package's ICP step is plain XLA
(pose6d_tpu/solvers/icp.py, kabsch.py). It is a torch.library op
(pose6d_tpu_torch::icp_kabsch_update): the dispatcher runs the
hand-written kernel on CUDA tensors and the plain PyTorch version beside
it on CPU tensors. One update is the distance gate, the gather of the
matched target rows, the weighted means, the centred cross-covariance,
Horn's 4x4 matrix, the JAX package's fixed 8-sweep Jacobi for its top
eigenvector, and R, t; a frame with fewer than 3 gated pairs keeps its
pose. The kernel does it in one launch with no host read; the plain
version repeats its arithmetic (sums in another order: the two agree to
float32 rounding).
"""
from __future__ import annotations

import torch

from . import _build

JACOBI_SWEEPS = 8
PIVOTS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def jacobi_eig4_maxvec(N, sweeps: int = JACOBI_SWEEPS):
    """The eigenvector of the largest eigenvalue of each symmetric 4x4
    N (..., 4, 4): cyclic Jacobi with a fixed sweep count over the
    entries as separate tensors, the JAX package's _jacobi_eig4_maxvec
    (pose6d_tpu/solvers/kabsch.py:27) operation for operation, its
    |apq| < 1e-30 guards included. Returns (..., 4), the first column on
    a tie of the diagonal."""
    a = [[N[..., i, j] for j in range(4)] for i in range(4)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(4)] for i in range(4)]
    for _ in range(sweeps):
        for p, q in PIVOTS:
            app, aqq, apq = a[p][p], a[q][q], a[p][q]
            tiny = torch.abs(apq) < 1e-30
            tau = (aqq - app) / (2.0 * torch.where(tiny, 1e-30, apq))
            tsign = torch.where(tau >= 0.0, 1.0, -1.0)
            tval = tsign / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            tval = torch.where(tiny, 0.0, tval)
            c = 1.0 / torch.sqrt(1.0 + tval * tval)
            s = tval * c
            for k in range(4):
                if k in (p, q):
                    continue
                akp, akq = a[k][p], a[k][q]
                a[k][p] = a[p][k] = c * akp - s * akq
                a[k][q] = a[q][k] = s * akp + c * akq
            a[p][p] = c * c * app - 2.0 * c * s * apq + s * s * aqq
            a[q][q] = s * s * app + 2.0 * c * s * apq + c * c * aqq
            a[p][q] = a[q][p] = zero
            for k in range(4):
                vkp, vkq = v[k][p], v[k][q]
                v[k][p] = c * vkp - s * vkq
                v[k][q] = s * vkp + c * vkq
    diag = torch.stack([a[i][i] for i in range(4)], -1)
    V = torch.stack([torch.stack(row, -1) for row in v], -2)
    pick = torch.argmax(diag, dim=-1)
    return torch.gather(V, -1, pick[..., None, None].expand(
        *pick.shape, 4, 1))[..., 0]


def horn_matrix(H):
    """Horn's (1987) symmetric 4x4 matrix of the cross-covariance H (...,
    3, 3): its top eigenvector is the quaternion of the proper rotation
    maximising trace(R^T H)."""
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = (
        r.unbind(-1) for r in H.unbind(-2))
    return torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)


def rotation_from_quat(q):
    """R (..., 3, 3) of the quaternion q (..., 4) = (w, x, y, z),
    normalised here (R src ~ dst for Horn's eigenvector)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rotation_from_h_jacobi(H):
    """The proper rotation maximising trace(R^T H), H (..., 3, 3), from
    Horn's matrix by the fixed-sweep Jacobi."""
    return rotation_from_quat(jacobi_eig4_maxvec(horn_matrix(H)))


def icp_kabsch_update_plain(src, src_valid, tgt, j, dmin, gate, R, t):
    """The kernel's arithmetic in PyTorch: gated weights, two-pass centred
    H (divided by W, plus 1e-12 I), Horn by Jacobi, t = mu_d - R mu_s;
    frames with W < 3 keep (R, t)."""
    w = src_valid & (dmin < gate[:, None])
    # gated rows only read tgt: the others gather row 0, weighted 0
    d = torch.gather(tgt, 1, (j.long() * w)[..., None].expand(-1, -1, 3))
    wf = w.float()[..., None]
    wsum = wf.sum(-2)
    applied = wsum[:, 0] >= 3
    denom = torch.clamp(wsum, min=1.0)
    mu_s = (src * wf).sum(-2) / denom
    mu_d = (d * wf).sum(-2) / denom
    H = ((src - mu_s[:, None]) * wf).transpose(-1, -2) @ (d - mu_d[:, None])
    H = H / denom[..., None] + 1e-12 * torch.eye(3, dtype=H.dtype,
                                                 device=H.device)
    R2 = rotation_from_h_jacobi(H)
    t2 = mu_d - (R2 @ mu_s[..., None])[..., 0]
    return (torch.where(applied[:, None, None], R2, R),
            torch.where(applied[:, None], t2, t), applied.to(torch.uint8))


def _check(src, src_valid, tgt, j, dmin, gate, R, t):
    bsz, n = src.shape[:2]
    m = tgt.shape[1]
    if (src.shape != (bsz, n, 3) or src_valid.shape != (bsz, n)
            or tgt.shape != (bsz, m, 3) or j.shape != (bsz, n)
            or dmin.shape != (bsz, n) or gate.shape != (bsz,)
            or R.shape != (bsz, 3, 3) or t.shape != (bsz, 3)):
        raise ValueError(
            f"bad shapes src{tuple(src.shape)} "
            f"src_valid{tuple(src_valid.shape)} tgt{tuple(tgt.shape)} "
            f"j{tuple(j.shape)} dmin{tuple(dmin.shape)} "
            f"gate{tuple(gate.shape)} R{tuple(R.shape)} t{tuple(t.shape)}")
    if any(x.dtype != torch.float32 for x in (src, tgt, dmin, gate, R, t)):
        raise TypeError("src, tgt, dmin, gate, R, t must be float32")
    if src_valid.dtype != torch.bool or j.dtype != torch.int32:
        raise TypeError("src_valid must be bool and j int32")


def _icp_launch(src, src_valid, tgt, j, dmin, gate, R, t):
    """Kernel launch on CUDA tensors (the op's CUDA implementation)."""
    _check(src, src_valid, tgt, j, dmin, gate, R, t)
    bsz, n = src.shape[:2]
    m = tgt.shape[1]
    if bsz == 0 or n == 0 or m == 0 or n >= 2 ** 24:
        raise ValueError(f"kernel takes 1 <= B, 1 <= M and 1 <= N < 2^24: "
                         f"B={bsz}, N={n}, M={m}")
    if any(x.device != src.device for x in (src_valid, tgt, j, dmin, gate,
                                            R, t)):
        raise ValueError("every input must be on one device")
    src, src_valid, tgt, j, dmin, gate, R, t = (
        x.contiguous() for x in (src, src_valid, tgt, j, dmin, gate, R, t))
    lib = _build.library("icp_kabsch_update.cu")
    R2, t2 = torch.empty_like(R), torch.empty_like(t)
    applied = torch.empty((bsz,), dtype=torch.uint8, device=src.device)
    code = lib.icp_kabsch_update_f32(
        src.data_ptr(), src_valid.data_ptr(), tgt.data_ptr(), j.data_ptr(),
        dmin.data_ptr(), gate.data_ptr(), R.data_ptr(), t.data_ptr(),
        R2.data_ptr(), t2.data_ptr(), applied.data_ptr(), bsz, n, m,
        _build.stream_ptr(src.device))
    _build.check(code, "icp_kabsch_update")
    _build.count_launch("icp_kabsch_update")
    return R2, t2, applied


@torch.library.custom_op("pose6d_tpu_torch::icp_kabsch_update",
                         mutates_args=(), device_types="cpu")
def _icp_op(src: torch.Tensor, src_valid: torch.Tensor, tgt: torch.Tensor,
            j: torch.Tensor, dmin: torch.Tensor, gate: torch.Tensor,
            R: torch.Tensor, t: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(src, src_valid, tgt, j, dmin, gate, R, t)
    return icp_kabsch_update_plain(src, src_valid, tgt, j, dmin, gate, R, t)


_icp_op.register_kernel("cuda")(_icp_launch)


@_icp_op.register_fake
def _(src, src_valid, tgt, j, dmin, gate, R, t):
    return (R.new_empty(R.shape), t.new_empty(t.shape),
            R.new_empty(R.shape[:1], dtype=torch.uint8))


def icp_kabsch_update(src, src_valid, tgt, j, dmin, gate, R, t):
    """One gated Kabsch update of ICP. src (B, N, 3) f32, src_valid (B, N)
    bool, tgt (B, M, 3) f32, j (B, N) int32 and dmin (B, N) f32 from
    nearest_valid, gate (B,) f32 squared correspondence distance, R (B,
    3, 3), t (B, 3) f32 the current pose. Returns the new R, t (the old
    ones where fewer than 3 pairs pass the gate) and applied (B,) uint8,
    1 where the update was taken."""
    return _icp_op(src, src_valid, tgt, j, dmin, gate, R, t)
