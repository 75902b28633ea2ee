"""LOBPCG for the top-k eigenpairs of a dense symmetric matrix.

A port of the algorithm of ``jax.experimental.sparse.linalg.
lobpcg_standard`` (JAX, Apache 2.0; jax/experimental/sparse/linalg.py),
which the JAX package's device_lbo calls: an orthonormal X / P / R
block basis kept by SVQB (twice), residuals projected out of (X, P)
"twice is enough" style with suspicious columns zeroed, Rayleigh-Ritz
on the 3k basis, the next P from the QR of Q[:k, k:]^T, a Householder
extension for the first P, and the stop rule `i < m and converged < k`
with JAX's self-consistency tolerance. torch.lobpcg is a different
algorithm and is not used.

Everything runs on the device of the inputs. An iteration is one
out-of-place step driven by ops/loops.run_while (a Python loop eagerly,
the while_loop op under torch.export, as lax.while_loop in JAX): the
stop rule reads the converged count on the host once per iteration, and
torch.linalg.eigh on CUDA waits for its own error check, so each
iteration syncs.
"""
from __future__ import annotations

import torch

from ..ops.loops import run_while


def _norms(x):
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _eigh_descending(a):
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def _svqb(x):
    """A truncated orthonormal basis of x's columns: trailing columns are
    zeroed where x is rank deficient."""
    norms = _norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis, u):
    """u's component orthogonal to the orthonormal (zero columns allowed)
    basis, orthonormalized; columns that could carry basis components
    back in are zeroed."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_norms(u) >= 0.99).to(u.dtype)


def _rayleigh_ritz_orth(a, s):
    return _eigh_descending(s.T @ (a @ s))


def _extend_basis(x, m: int):
    """m columns orthonormal to the orthonormal (n, k) x, from block
    Householder reflectors (deterministic, never overlapping x)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype,
                                   device=x.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(a, x, m: int = 100, tol: float | None = None):
    """Top-k eigenpairs of the symmetric (n, n) matrix `a` from the (n, k)
    start block `x` (orthonormalized here; k * 5 < n). At most m
    iterations. Returns (theta (k,) descending, U (n, k), the
    iteration count as a 0-d int64 tensor)."""
    n, k = x.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"need 0 < 5 k < n, got k = {k}, n = {n}")
    if tol is None:
        tol = torch.finfo(x.dtype).eps
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a @ x
    theta = torch.sum(x * ax, dim=0, keepdim=True)
    r = ax - theta * x

    def more(i, converged, theta, x, p, r):
        return (i < m) & (converged < k)

    def step(i, converged, theta, x, p, r):
        r = _project_out(torch.cat([x, p], dim=1), r)
        xpr = torch.cat([x, p, r], dim=1)
        theta, q = _rayleigh_ritz_orth(a, xpr)
        b = q[:, :k]
        b = b / _norms(b)
        x = xpr @ b
        x = x / _norms(x)
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = _norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a @ x
        r = ax - theta[None, :k] * x
        resid = torch.linalg.vector_norm(r, dim=0)
        reltol = (torch.linalg.vector_norm(ax, dim=0) + theta[:k]) * n * 10
        converged = (resid < tol * reltol).sum()
        return i + 1, converged, theta[:k][None], x, p, r

    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    i, _, theta, x, _, _ = run_while(more, step, (zero, zero, theta, x, p, r))
    return theta[0], x, i
