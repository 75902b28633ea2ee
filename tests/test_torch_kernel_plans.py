"""The wrapper logic around the redesigned kernel paths, on the CPU: the
masked cdist wide kernel's route by M and shared memory, the flash
forward's instance for head dims 33 to 128 (the tensor-core kernel),
the padding and fold around a stand-in launch, and the tensor-core
forward's and the wide backward kernels' 3xTF32 arithmetic emulated
against float64."""
import numpy as np
import pytest
import torch

from pose6d_tpu_torch.ops.kernels import attention as kattn
from pose6d_tpu_torch.ops.kernels import cdist as kcdist

torch.set_num_threads(2)

H100_OPTIN = 232448        # shared memory a block may opt in to (H100)


@pytest.mark.parametrize("m,optin,route", [
    (5120, H100_OPTIN, "wide"),         # the spectral filter's CAD columns
    (2048, H100_OPTIN, "wide"),
    (5183, H100_OPTIN, "wide"),         # the largest M that fits
    (5184, H100_OPTIN, "wide_walk"),
    (100000, H100_OPTIN, "wide_walk"),
    (5120, 101376, "wide_walk"),        # a card with 99 KB a block
    (1024, 101376, "wide"),
])
def test_wide_route_by_columns_and_shared_memory(m, optin, route):
    """The wide kernel keeps its 8 rows' d2 in shared memory where 8 M
    floats fit beside its stage buffers, and recomputes the walk each
    radix pass otherwise; no M is refused."""
    assert kcdist.wide_route(m, optin) == route
    need = kcdist.WIDE_SMEM_FIXED + kcdist.WIDE_SMEM_PER_COLUMN * m
    assert (need <= optin) == (route == "wide")


def test_wide_route_shared_memory_is_eight_rows():
    """The per-column cost is 8 rows of f32 (one row per warp of the
    256-thread block); the fixed part is the two stage buffers of 512
    columns and 8 rows x 16 features plus 8 row norms."""
    assert kcdist.WIDE_SMEM_PER_COLUMN == 8 * 4
    assert kcdist.WIDE_SMEM_FIXED == 4 * (2 * (512 + 8) * 16 + 8)


@pytest.mark.parametrize("dim", [33, 40, 48, 63, 64, 65, 80, 96, 127, 128])
def test_forward_instance_for_dims_33_to_128(dim):
    """Head dims 33-64 run the DIM 64 instance, 65-128 the DIM 128 one,
    both the tensor-core kernel at 64 queries a block (4 warps of 16);
    every head count folds into one-head frames there."""
    inst = kattn.instance_dim(dim)
    assert inst == (64 if dim <= 64 else 128)
    assert kattn.flash_queries_per_block(1, inst) == 64
    for heads in (1, 2, 3, 8):
        assert kattn.kernel_instance(4, dim, heads) == (4 * heads, 1)


@pytest.mark.parametrize("dim,heads", [(33, 1), (40, 2), (63, 3), (64, 1),
                                       (65, 2), (96, 1), (127, 2), (128, 3)])
def test_forward_pad_and_fold_at_dims_33_to_128(dim, heads, monkeypatch):
    """The forward wrapper pads dims 33-128 to their instance and folds
    the heads into frames around a stand-in launch (the plain version on
    the laid-out tensors): the output and lse equal the plain version of
    the call, the launch sees the instance dim with one head, B H frames
    and the caller's scale, and a key-less frame gives zeros and lse =
    -inf."""
    rng = np.random.default_rng(dim * 10 + heads)
    bsz, n, m = 2, 18, 37
    q, k, v = (torch.as_tensor(rng.normal(size=(bsz, s, dim, heads)),
                               dtype=torch.float32) for s in (n, m, m))
    kv = torch.as_tensor(rng.random((bsz, m)) > 0.3)
    kv[1] = False
    sc = dim ** -0.5
    seen = []

    def fwd(q_, k_, v_, kv_, scale, with_lse, segments, instance):
        seen.append((tuple(q_.shape), tuple(k_.shape), scale, instance))
        return (kattn.flash_cross_attention_plain(q_, k_, v_, kv_, scale)
                .contiguous(),
                kattn.flash_cross_attention_lse_plain(q_, k_, kv_, scale))

    monkeypatch.setattr(kattn, "_forward_launch", fwd)
    out, lse = kattn._forward_kernel(q, k, v, kv, sc, True)
    inst = kattn.instance_dim(dim)
    assert seen == [((bsz * heads, n, inst, 1), (bsz * heads, m, inst, 1),
                     sc, (dim, heads))]
    torch.testing.assert_close(
        out, kattn.flash_cross_attention_plain(q, k, v, kv, sc), rtol=0,
        atol=1e-6)
    torch.testing.assert_close(
        lse, kattn.flash_cross_attention_lse_plain(q, k, kv, sc), rtol=0,
        atol=1e-5)
    assert out.shape == q.shape and out.is_contiguous()
    assert not out[1].any() and bool((lse[1] == -np.inf).all())


def _split(x):
    """x = hi + lo as mma_tf32.cuh splits an f32 operand (hi: x with its
    low 13 bits dropped; lo: the exact rest as the tensor core reads it,
    its low 13 bits dropped too)."""
    x = np.ascontiguousarray(x, np.float32)
    hi = (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    lo = ((x - hi).view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    return hi, lo


def _mma3(acc, a, b, steps):
    """acc + a @ b in 3xTF32 mma.sync steps: `steps` lists the k indices
    of each m16n8k8 step; per step the products a_lo b_hi, a_hi b_lo and
    a_hi b_hi (each exact in float64) are added to the f32 accumulator
    one mma at a time."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    for ks in steps:
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc + x[:, ks].astype(np.float64)
                   @ y[ks].astype(np.float64)).astype(np.float32)
    return acc


def _forward_tc(q, k, v, valid, scale):
    """flash_fwd_tc_kernel's arithmetic on one frame and head (numpy f32,
    q (N, D), k / v (M, D)): per tile of 32 keys S in 3xTF32 over the
    kernel's k-steps (step s: dims 16 (s / 2) + 4 t + 2 (s % 2) + {0, 1}),
    masked to -inf, the online softmax with exp2 and log2(e) folded into
    the scale (q pre-scaled for a power-of-two scale), O += P V in 3xTF32
    over steps of 8 keys; out = O / l, lse = max + log l."""
    d = q.shape[1]
    f32 = np.float32
    pow2 = np.frexp(f32(scale))[0] == 0.5
    if pow2:
        q = (q * f32(scale)).astype(f32)
    unit = f32(1) if pow2 else f32(scale)
    sl2e = f32(unit * f32(np.log2(np.e)))
    s_steps = [np.array([16 * (s // 2) + 4 * t + 2 * (s % 2) + h
                         for t in range(4) for h in range(2)])
               for s in range(d // 8)]
    n = q.shape[0]
    o = np.zeros((n, d), f32)
    mx = np.full(n, -np.inf, f32)
    ls = np.zeros(n, f32)
    for j0 in range(0, k.shape[0], 32):
        kv = valid[j0:j0 + 32]
        if not kv.any():
            continue                        # the kernel skips the tile
        kt, vt = k[j0:j0 + 32], v[j0:j0 + 32]
        s = _mma3(np.zeros((n, len(kt)), f32), q, kt.T, s_steps)
        s = np.where(kv[None], s, -np.inf).astype(f32)
        nm = np.maximum(mx, s.max(1))
        corr = np.exp2((mx.astype(np.float64) - nm) * sl2e).astype(f32)
        nml = (nm * sl2e).astype(f32)
        p = np.exp2((s.astype(np.float64) * sl2e - nml[:, None])
                    .astype(f32)).astype(f32)
        ls = (ls * corr + p.sum(1, dtype=f32)).astype(f32)
        o = (o * corr[:, None]).astype(f32)
        o = _mma3(o, p, vt, [np.arange(c, min(c + 8, len(kt)))
                             for c in range(0, len(kt), 8)])
        mx = nm
    with np.errstate(divide="ignore"):
        inv = np.where(ls > 0, f32(1) / ls, f32(0))
        lse = np.where(ls > 0, mx * unit + np.log(ls), -np.inf)
    return (o * inv[:, None]).astype(f32), lse.astype(f32)


@pytest.mark.parametrize("dim,n_valid", [(64, 93), (128, 93), (64, 0),
                                         (128, 160)])
def test_forward_3xtf32_emulation_within_tolerance(dim, n_valid):
    """The tensor-core forward's precision, emulated, against float64:
    out within 2e-6 of max |v| + 2e-6 of max |out| and lse within 1e-5 (1
    + |lse|); the f32 plain version's own error is printed beside it. A
    scale of 1 / sqrt(dim) is a power of two at 64 and not at 128, so
    both scale paths run. Zero valid keys: zeros and lse = -inf."""
    rng = np.random.default_rng(dim + n_valid)
    n, m = 40, 160
    q, k, v = (rng.normal(size=(s, dim)).astype(np.float32)
               for s in (n, m, m))
    valid = np.zeros(m, bool)
    valid[rng.permutation(m)[:n_valid]] = True
    scale = dim ** -0.5
    out, lse = _forward_tc(q, k, v, valid, scale)
    tq, tk, tv = (torch.as_tensor(x)[None, :, :, None] for x in (q, k, v))
    tvalid = torch.as_tensor(valid)[None]
    ref = kattn.flash_cross_attention_plain(
        tq.double(), tk.double(), tv.double(), tvalid, scale)[0, :, :, 0]
    lref = kattn.flash_cross_attention_lse_plain(
        tq.double(), tk.double(), tvalid, scale)[0, :, 0].numpy()
    ref = ref.numpy()
    if n_valid == 0:
        assert not out.any() and bool((lse == -np.inf).all())
        return
    tol = 2e-6 * np.abs(v).max() + 2e-6 * np.abs(ref).max()
    err = np.abs(out - ref).max()
    plain = kattn.flash_cross_attention_plain(
        tq, tk, tv, tvalid, scale)[0, :, :, 0].numpy()
    print(f"dim {dim}: emulated {err:.3g}, plain f32 "
          f"{np.abs(plain - ref).max():.3g}, tol {tol:.3g}")
    assert err <= tol
    np.testing.assert_allclose(lse, lref, rtol=0,
                               atol=1e-5 * (1 + np.abs(lref).max()))


# the 3xTF32 steps of a product over DIM as the kernels order its k index
# (k-step 2 p + e: dims 16 p + 4 t + 2 e + {0, 1}, t = 0..3)
def _dim_steps(d):
    return [np.array([16 * (s // 2) + 4 * t + 2 * (s % 2) + h
                      for t in range(4) for h in range(2)])
            for s in range(d // 8)]


def _fma(a, b, c):
    """f32 fma (the product exact in float64, one rounding)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _backward_wide(q, k, v, valid, scale, out, lse, dout):
    """flash_bwd_dq_wide_kernel's and flash_bwd_dkv_wide_kernel's
    arithmetic on one frame and head (numpy f32, q / out / dout (N, D), k
    / v (M, D)): the prep pass (D = dout . out an FMA chain in dim order;
    L log2 e, or +inf for a row whose dout is all zero or L = -inf); the
    dq kernel per tile of 32 valid-key-holding keys: s and dout . v in
    3xTF32 over the permuted k-steps, P = exp2(fma(s, scale log2 e, -L
    log2 e)) (0 on masked keys), dS = P (dP - D), dq += dS k in 3xTF32
    over steps of 8 keys; the dkv kernel per tile of 32 queries with a
    live row likewise for s^T, dv += P^T dout, dk += dS^T q; dq and dk
    times the scale, masked keys' dk and dv zero."""
    f32 = np.float32
    log2e = f32(np.log2(np.e))
    sl2e = f32(f32(scale) * log2e)
    n, d = q.shape
    m = k.shape[0]
    steps = _dim_steps(d)
    dd = np.zeros(n, f32)
    for c in range(d):
        dd = _fma(dout[:, c], out[:, c], dd)
    live = (dout != 0).any(1) & (lse != -np.inf)
    l2 = np.where(live, (lse * log2e).astype(f32), f32(np.inf))

    def probs(s, l2r, mask):
        x = _fma(s, sl2e, -l2r)
        return np.where(mask, np.exp2(x.astype(np.float64)).astype(f32), 0)

    dq = np.zeros((n, d), f32)
    for j0 in range(0, m, 32):
        kv = valid[j0:j0 + 32]
        if not kv.any():
            continue                        # the kernel skips the tile
        kt, vt = k[j0:j0 + 32], v[j0:j0 + 32]
        s = _mma3(np.zeros((n, len(kt)), f32), q, kt.T, steps)
        dp = _mma3(np.zeros((n, len(kt)), f32), dout, vt.T, steps)
        p = probs(s, l2[:, None], kv[None])
        ds = (p * (dp - dd[:, None])).astype(f32)
        dq = _mma3(dq, ds, kt, [np.arange(c, min(c + 8, len(kt)))
                                for c in range(0, len(kt), 8)])
    dk, dv = np.zeros((m, d), f32), np.zeros((m, d), f32)
    for i0 in range(0, n, 32):
        if not live[i0:i0 + 32].any():
            continue                        # the kernel skips the tile
        qt, gt = q[i0:i0 + 32], dout[i0:i0 + 32]
        st = _mma3(np.zeros((m, len(qt)), f32), k, qt.T, steps)
        dpt = _mma3(np.zeros((m, len(qt)), f32), v, gt.T, steps)
        pt = probs(st, l2[None, i0:i0 + 32], True)
        dst = (pt * (dpt - dd[None, i0:i0 + 32])).astype(f32)
        chunks = [np.arange(c, min(c + 8, len(qt)))
                  for c in range(0, len(qt), 8)]
        dv = _mma3(dv, pt, gt, chunks)
        dk = _mma3(dk, dst, qt, chunks)
    return ((dq * f32(scale)).astype(f32),
            np.where(valid[:, None], dk * f32(scale), 0).astype(f32),
            np.where(valid[:, None], dv, 0).astype(f32))


@pytest.mark.parametrize("dim,case", [(64, "masks"), (128, "masks"),
                                      (64, "no_keys"), (128, "dead_rows")])
def test_backward_wide_3xtf32_emulation_within_tolerance(dim, case):
    """The wide backward kernels' precision (DIM 64 and 128), emulated,
    against autograd through the float64 plain attention: dq, dk, dv
    each within 2e-5 of its largest entry (the emulation adds each mma's
    products exactly; the card's mma rounds inside them, and
    chip_smoke.py holds the card to 1e-4 of it, FLASH_BWD_F64_TOL); the
    f32 plain version's own error printed beside it. "masks": random valid keys
    and a tenth of the queries dead (dout 0); "no_keys": no valid key, so
    every gradient is zero; "dead_rows": a prefix of live queries, so
    whole query tiles are skipped (their dq zero). A scale of 1 /
    sqrt(dim) is a power of two at 64 and not at 128."""
    rng = np.random.default_rng(dim + len(case))
    n, m = 72, 90                 # partial tiles of 32 on both sides
    q, k, v = (rng.normal(size=(s, dim)).astype(np.float32)
               for s in (n, m, m))
    valid = rng.random(m) > 0.3
    q_live = rng.random(n) > 0.1
    if case == "no_keys":
        valid[:] = False
    if case == "dead_rows":
        q_live = np.arange(n) < 27
    dout = (rng.normal(size=(n, dim)) * q_live[:, None]).astype(np.float32)
    scale = dim ** -0.5
    tq, tk, tv, tg = (torch.as_tensor(x)[None, :, :, None]
                      for x in (q, k, v, dout))
    tvalid = torch.as_tensor(valid)[None]
    out = kattn.flash_cross_attention_plain(tq, tk, tv, tvalid, scale)
    lse = kattn.flash_cross_attention_lse_plain(tq, tk, tvalid, scale)
    got = _backward_wide(q, k, v, valid, scale, out[0, :, :, 0].numpy(),
                         lse[0, :, 0].numpy(), dout)
    if case == "no_keys":
        assert not any(x.any() for x in got)
        return
    want = kattn.flash_cross_attention_backward(
        *(x.double() for x in (tq, tk, tv)), tvalid, scale, None, None,
        tg.double())
    plain = kattn.flash_cross_attention_backward(tq, tk, tv, tvalid, scale,
                                                 None, None, tg)
    for name, a, b, c in zip("qkv", got, want, plain):
        b, c = b[0, :, :, 0].numpy(), c[0, :, :, 0].numpy()
        top = np.abs(b).max()
        err = np.abs(a - b).max() / top
        print(f"dim {dim} {case} d{name}: emulated {err:.3g}, plain f32 "
              f"{np.abs(c - b).max() / top:.3g} of max |ref|")
        assert err <= 2e-5
    assert not got[0][~q_live].any()            # dead rows: dq = 0
    assert not got[1][~valid].any() and not got[2][~valid].any()
