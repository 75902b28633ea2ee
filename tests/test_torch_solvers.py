"""The port's solvers on the CPU against the JAX package on the same
numpy inputs: spatial filter (rank-major), Kabsch / triad, RANSAC with
shared draws, cloud-to-model ICP; and the port's two Horn solvers
(Kabsch's eigh, the ICP update's Jacobi) against each other."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu import solvers as jax_solvers
from pose6d_tpu.solvers import kabsch as jax_kabsch
from pose6d_tpu_torch import solvers
from pose6d_tpu_torch.ops.kernels import icp_kabsch_update
from pose6d_tpu_torch.solvers import kabsch
from pose6d_tpu_torch.solvers import ransac as ransac_mod

torch.set_num_threads(2)


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_filter_matches_jax_rank_major():
    """Fed the same C, pairs and masks must be exact (well-separated
    random geometry; the same construction as tests/test_solvers.py's
    rank-major parity test)."""
    rng = np.random.default_rng(11)
    v1, v2, k = 256, 128, 30
    cad = (rng.normal(size=(v1, 3)) * 2).astype(np.float32)
    perm = rng.permutation(v1)[:v2]
    pc = (cad[perm] @ _rotation(rng).T + rng.normal(size=3)
          ).astype(np.float32)
    evecs_x = np.linalg.qr(rng.normal(size=(v1, k)))[0].astype(np.float32)
    evecs_y = evecs_x[perm].copy()
    bad = rng.choice(v2, 40, replace=False)
    evecs_y[bad] = np.linalg.qr(rng.normal(size=(v1, k)))[0][:len(bad)]
    C = (np.eye(k) + 0.01 * rng.normal(size=(k, k))).astype(np.float32)
    diam = float(np.linalg.norm(cad.max(0) - cad.min(0)))
    x_valid = np.arange(v1) < 250
    y_valid = np.ones(v2, bool)
    y_valid[rng.choice(v2, 9, replace=False)] = False
    args = (C, evecs_x, evecs_y, cad, pc, x_valid, y_valid)
    jp, jv = jax_solvers.spatial_filtering_fmap2pointmap(
        *(jnp.asarray(a) for a in args), diam, k=5, rank_major=True)
    tp, tv = solvers.spatial_filtering_fmap2pointmap(
        *(_t(a)[None] for a in args), torch.tensor([diam]))
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < 5 * v2


def test_triad_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(32, 3, 3)).astype(np.float32)
    dst = rng.normal(size=(32, 3, 3)).astype(np.float32)
    jR, jt = jax.vmap(jax_kabsch.triad_rigid)(jnp.asarray(src),
                                              jnp.asarray(dst))
    R, t = kabsch.triad_rigid(_t(src), _t(dst))
    # a few cross products and normalizations in f32
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "weighted", "zero_weights",
                                  "collinear", "reflection_prone"])
def test_kabsch_matches_jax(case):
    """Case "reflection_prone": a nearly planar set, where an unsigned
    SVD solution would be a reflection; Horn's quaternion is always
    proper."""
    rng = np.random.default_rng(2)
    R_gt = _rotation(rng)
    src = rng.normal(size=(4, 60, 3)).astype(np.float32) * 3
    if case == "reflection_prone":
        src[..., 2] *= 1e-3
    if case == "collinear":
        src = np.linspace(0, 1, 60, dtype=np.float32)[None, :, None] \
            * rng.normal(size=(4, 1, 3)).astype(np.float32)
    dst = (src @ R_gt.T + np.array([1.0, -2.0, 0.5], np.float32)
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    w = None
    if case == "weighted":
        w = rng.random((4, 60)).astype(np.float32)
    elif case == "zero_weights":
        w = np.zeros((4, 60), np.float32)
    jw = None if w is None else jnp.asarray(w)
    jR, jt = jax.vmap(lambda s, d, ww: jax_kabsch.kabsch_umeyama(s, d, ww),
                      in_axes=(0, 0, None if w is None else 0))(
        jnp.asarray(src), jnp.asarray(dst), jw)
    R, t = kabsch.kabsch_umeyama(_t(src), _t(dst), torch.ones(4, 60)
                                 if w is None else _t(w))
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    np.testing.assert_allclose(
        (R @ R.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3), (4, 3, 3)),
        atol=1e-5)
    if case == "collinear":
        # rotation about the line is undetermined: compare the residuals
        res = kabsch.transform_residuals(R, t, _t(src), _t(dst)).numpy()
        jres = np.asarray(jax.vmap(jax_kabsch.transform_residuals)(
            jR, jt, jnp.asarray(src), jnp.asarray(dst)))
        np.testing.assert_allclose(res, jres, atol=1e-4)
        return
    # eigh vs unrolled Jacobi on a well-separated top eigenvalue: both
    # reach f32 precision (q and -q give the same R)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)


@pytest.mark.parametrize("case", ["plain", "reflection_prone",
                                  "partial_mask", "two_pairs", "all_masked"])
def test_kabsch_agrees_with_icp_update(case):
    """The port's two Horn solvers at binary weights: kabsch_umeyama
    (eigh; RANSAC's refits and GNC) and the ICP update's op (on the CPU
    its plain twin: fixed-sweep Jacobi, the kernel's arithmetic), fed the
    pairs as nearest neighbours j = i. A pair is masked as padding
    (src_valid) or past the gate (dmin). Where at least 3 pairs pass, the
    same (R, t) to f32 rounding; below 3 the update keeps its pose."""
    rng = np.random.default_rng(7)
    bsz, n = 4, 60
    R_gt = _rotation(rng)
    src = rng.normal(size=(bsz, n, 3)).astype(np.float32) * 3
    if case == "reflection_prone":
        src[..., 2] *= 1e-3
    dst = (src @ R_gt.T + np.array([1.0, -2.0, 60.0], np.float32)
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    on = np.ones((bsz, n), bool)
    if case == "partial_mask":
        on = rng.random((bsz, n)) > 0.5
    elif case == "two_pairs":
        on[:, 2:] = False
    elif case == "all_masked":
        on[:] = False
    even = np.arange(n) % 2 == 0
    src_valid = ~(~on & even)
    dmin = np.where(~on & ~even, 2.0, 0.5).astype(np.float32)
    R0 = torch.as_tensor(_rotation(rng)).expand(bsz, 3, 3).contiguous()
    t0 = torch.tensor([0.5, 0.5, 50.0]).expand(bsz, 3).contiguous()
    j = torch.arange(n, dtype=torch.int32).expand(bsz, n).contiguous()
    R, t = kabsch.kabsch_umeyama(_t(src), _t(dst), _t(on.astype(np.float32)))
    Ru, tu, applied = icp_kabsch_update(_t(src), _t(src_valid), _t(dst), j,
                                        _t(dmin), torch.ones(bsz), R0, t0)
    enough = on.sum(-1) >= 3
    np.testing.assert_array_equal(applied.numpy(), enough)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
    if enough.any():
        # eigh against 8 Jacobi sweeps, weights normalised before H
        # against after: a few f32 ulps of R and of |t| ~ 60
        np.testing.assert_allclose(Ru[enough].numpy(), R[enough].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tu[enough].numpy(), t[enough].numpy(),
                                   rtol=0, atol=1e-4)
    assert torch.equal(Ru[~enough], R0[~enough])
    assert torch.equal(tu[~enough], t0[~enough])


@pytest.mark.parametrize("ratio", [0.05, 0.25, 0.6, 0.9])
def test_required_trials_is_the_triad_bound(ratio):
    """The early-exit bound log(1 - confidence) / log(1 - eps^3) at an
    inlier ratio eps, against float64, for three frames of 280 valid
    pairs."""
    n_valid = torch.full((3,), 280.0)
    best = torch.tensor([ratio * 280.0] * 3)
    eps = float(best[0] / n_valid[0])
    want = np.log1p(-ransac_mod.CONFIDENCE) / np.log1p(-eps ** 3)
    got = ransac_mod._required_trials(best, n_valid)
    assert got.dtype == torch.float32
    # f32 against float64: an ulp or so
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _jax_uniforms(key, n_blocks, hyp_block):
    """The draws ransac_pose makes: split the key once per block, then
    one uniform (hyp_block, 3) draw from the sub-key."""
    out = []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (hyp_block, 3))))
    return np.stack(out)


def _shared_draw_case():
    """Two frames of 300 correspondences, 60 % and 25 % inliers, so they
    exit after different block counts (the low one after several blocks);
    2048 hypotheses in blocks of 64. Returns (src, dst, valid) numpy
    stacks and each frame's JAX key."""
    rng = np.random.default_rng(3)
    n = 300
    srcs, dsts, valids = [], [], []
    for ratio in (0.6, 0.25):
        src = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
        R_gt = _rotation(rng)
        dst = src @ R_gt.T + np.array([3.0, 1.0, 40.0], np.float32)
        out = rng.random(n) > ratio
        dst[out] = rng.normal(size=(out.sum(), 3)) * 5 + 40
        dst = dst.astype(np.float32)
        valid = np.arange(n) < 280
        srcs.append(src); dsts.append(dst); valids.append(valid)
    keys = [jax.random.PRNGKey(f) for f in range(2)]
    return np.stack(srcs), np.stack(dsts), np.stack(valids), keys


def test_ransac_matches_jax_with_shared_draws():
    n_hyp, hyp_block = 2048, 64
    src, dst, valid, keys = _shared_draw_case()
    refs = [jax_solvers.ransac_pose(
        key, jnp.asarray(src[f]), jnp.asarray(dst[f]),
        jnp.asarray(valid[f]), threshold=0.5, n_hypotheses=n_hyp,
        hyp_block=hyp_block) for f, key in enumerate(keys)]
    us = [_jax_uniforms(key, n_hyp // hyp_block, hyp_block) for key in keys]
    res = solvers.ransac_pose(_t(src), _t(dst), _t(valid), threshold=0.5,
                              n_hypotheses=n_hyp, hyp_block=hyp_block,
                              uniforms=_t(np.stack(us)))
    trials = [int(r["n_trials"]) for r in refs]
    assert trials[0] < trials[1]
    for f, ref in enumerate(refs):
        assert int(res["n_trials"][f]) == trials[f]
        assert int(res["n_inliers"][f]) == int(ref["n_inliers"])
        # same hypothesis, then two f32 least-squares refits
        np.testing.assert_allclose(res["R"][f].numpy(), np.asarray(ref["R"]),
                                   atol=1e-4)
        np.testing.assert_allclose(res["t"][f].numpy(), np.asarray(ref["t"]),
                                   atol=1e-4 * 50)   # 1e-4 of |t| ~ 40


def _ransac_pose_inline(src, dst, valid, threshold, n_hypotheses, hyp_block,
                        uniforms):
    """solvers.ransac_pose as it ran before its scoring became a kernel
    op, as a plain loop: the draws indexed through the valid indices,
    every frame scored on (B, H, N) residual planes in every block."""
    bsz, n = valid.shape
    n_blocks = n_hypotheses // hyp_block
    threshold = torch.full((bsz,), threshold)
    thr2 = (threshold * threshold)[:, None, None]
    vmask = valid.float()
    n_valid = torch.clamp(vmask.sum(-1), min=1.0)
    valid_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    n_valid_i = valid.sum(-1).to(torch.int32)
    max_slot = torch.clamp(n_valid_i - 1, min=0)[:, None, None]
    rows = torch.arange(bsz)[:, None, None]
    ar = torch.arange(bsz)
    R = torch.eye(3).expand(bsz, 3, 3).clone()
    t = torch.zeros((bsz, 3))
    best = torch.zeros(bsz)
    done = torch.zeros(bsz, dtype=torch.int64)
    for blk in range(n_blocks):
        active = (done < n_blocks) & (done * hyp_block < ransac_mod.
                                      _required_trials(best, n_valid))
        if not active.any():
            break
        slots = (uniforms[:, blk] * n_valid_i.float()[:, None, None]).to(
            torch.int32)
        slots = torch.minimum(slots, max_slot).long()
        samples = torch.gather(valid_idx, 1, slots.reshape(bsz, -1))
        samples = samples.reshape(bsz, hyp_block, 3)
        Rs, ts = kabsch.triad_rigid(src[rows, samples], dst[rows, samples])
        d2 = torch.zeros((bsz, hyp_block, n), dtype=torch.float32)
        for i in range(3):
            pred_i = (Rs[:, :, i, 0, None] * src[:, None, :, 0]
                      + Rs[:, :, i, 1, None] * src[:, None, :, 1]
                      + Rs[:, :, i, 2, None] * src[:, None, :, 2]
                      + ts[:, :, i, None])
            d2 = d2 + (pred_i - dst[:, None, :, i]) ** 2
        counts = ((d2 < thr2) * vmask[:, None]).sum(-1)
        b = torch.argmax(counts, dim=-1)
        Rb, tb, cb = Rs[ar, b], ts[ar, b], counts[ar, b]
        better = active & (cb > best)
        R = torch.where(better[:, None, None], Rb, R)
        t = torch.where(better[:, None], tb, t)
        best = torch.where(active, torch.maximum(best, cb), best)
        done = done + active.to(torch.int64)
    for _ in range(ransac_mod.REFIT_ROUNDS):
        r = kabsch.transform_residuals(R, t, src, dst)
        w = ((r < threshold[:, None]) & valid).float()
        R2, t2 = kabsch.kabsch_umeyama(src, dst, w)
        ok = w.sum(-1) >= 3
        R = torch.where(ok[:, None, None], R2, R)
        t = torch.where(ok[:, None], t2, t)
    r = kabsch.transform_residuals(R, t, src, dst)
    inliers = (r < threshold[:, None]) & valid
    n_inl = inliers.sum(-1)
    return {"R": R, "t": t, "inliers": inliers, "n_inliers": n_inl,
            "n_trials": done * hyp_block, "ok": n_inl >= 3}


# ids: points per hypothesis (triads), pairs scattered
@pytest.mark.parametrize("scattered", [False, True],
                         ids=["3-False", "3-True"])
def test_ransac_pose_bit_identical_to_inline_scoring(scattered, monkeypatch):
    """The shared-draw case (JAX's draws; scattered: its pairs permuted,
    so that the valid ones are no prefix) gives ransac_pose's results of
    before the kernel op, bit for bit, with its refits and without them
    (the winning hypotheses themselves): the compacted pairs, the op's
    counts and the skipped exited frames move nothing."""
    n_hyp, hyp_block = 2048, 64
    src, dst, valid, keys = _shared_draw_case()
    if scattered:
        perm = np.random.default_rng(4).permutation(valid.shape[1])
        src, dst, valid = src[:, perm], dst[:, perm], valid[:, perm]
    u = np.stack([_jax_uniforms(key, n_hyp // hyp_block, hyp_block)
                  for key in keys])
    args = (_t(src), _t(dst), _t(valid), 0.5, n_hyp, hyp_block, _t(u))
    for refits in (ransac_mod.REFIT_ROUNDS, 0):
        monkeypatch.setattr(ransac_mod, "REFIT_ROUNDS", refits)
        got = solvers.ransac_pose(*args[:4], n_hypotheses=n_hyp,
                                  hyp_block=hyp_block, uniforms=args[6])
        want = _ransac_pose_inline(*args)
        trials = want["n_trials"].tolist()
        assert trials[0] < trials[1] <= n_hyp     # frames exit apart
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), \
                (refits, k)


@pytest.mark.parametrize("coarse_stride", [1, 4])
def test_icp_cloud_to_model_matches_jax(coarse_stride):
    rng = np.random.default_rng(4)
    cad = (rng.normal(size=(400, 3)) * 3).astype(np.float32)
    cad_valid = np.arange(400) < 380
    R_gt = _rotation(rng)
    t_gt = np.array([1.0, 2.0, 60.0], np.float32)
    sel = rng.permutation(380)[:150]
    pc = (cad[sel] @ R_gt.T + t_gt + 0.01 * rng.normal(size=(150, 3))
          ).astype(np.float32)
    pc = np.concatenate([pc, np.zeros((10, 3), np.float32)])
    pc_valid = np.arange(160) < 150
    a = np.radians(5.0)   # start 5 degrees off about z, 0.5 cm off
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    R0 = (R_gt @ Rz).astype(np.float32)
    t0 = t_gt + np.array([0.3, -0.2, 0.4], np.float32)
    args = (cad, cad_valid, pc, pc_valid, R0, t0)
    ref = jax_solvers.icp_cloud_to_model(
        *(jnp.asarray(a) for a in args), max_corr_dist=2.0, max_iter=12,
        coarse_stride=coarse_stride, fine_iters=5)
    out = solvers.icp_cloud_to_model(
        *(_t(a)[None] for a in args), max_corr_dist=2.0, max_iter=12,
        coarse_stride=coarse_stride)
    # identical correspondences each step; f32 Kabsch (eigh vs Jacobi)
    np.testing.assert_allclose(out["R"][0].numpy(), np.asarray(ref["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(out["t"][0].numpy(), np.asarray(ref["t"]),
                               atol=1e-3)
    np.testing.assert_allclose(out["rmse"][0].numpy(),
                               np.asarray(ref["rmse"]), rtol=1e-3)
    assert int(out["n_corr"][0]) == int(ref["n_corr"])


def _icp_inline(src, src_valid, tgt, tgt_valid, R0, t0, max_corr_dist,
                max_iter, coarse_stride, fine_iters=5):
    """icp_point2point as it ran before the update op: the gate, the
    gather and kabsch_umeyama (Horn by torch.linalg.eigh) inline, the
    update kept where at least 3 pairs pass."""
    from pose6d_tpu_torch.ops.nn import nearest_valid
    bsz = src.shape[0]
    gate = torch.as_tensor(max_corr_dist, dtype=torch.float32).expand(
        bsz)[:, None] ** 2

    def nn_pairs(R, t, tg, tv):
        moved = src @ R.transpose(-1, -2) + t[:, None, :]
        dmin, j = nearest_valid(moved, tg, tv)
        return j, (src_valid & (dmin < gate)).float(), dmin

    def iterate(R, t, tg, tv, n):
        for _ in range(n):
            j, w, _ = nn_pairs(R, t, tg, tv)
            ok = w.sum(-1) >= 3
            R2, t2 = kabsch.kabsch_umeyama(src, torch.gather(
                tg, 1, j.long()[..., None].expand(-1, -1, 3)), w)
            R = torch.where(ok[:, None, None], R2, R)
            t = torch.where(ok[:, None], t2, t)
        return R, t

    R, t = R0, t0
    n_fine = max_iter if coarse_stride <= 1 else min(fine_iters, max_iter)
    if max_iter - n_fine > 0:
        R, t = iterate(R, t, tgt[:, ::coarse_stride],
                       tgt_valid[:, ::coarse_stride], max_iter - n_fine)
    R, t = iterate(R, t, tgt, tgt_valid, n_fine)
    _, w, dmin = nn_pairs(R, t, tgt, tgt_valid)
    n_corr = w.sum(-1)
    rmse = torch.sqrt((dmin * w).sum(-1) / torch.clamp(n_corr, min=1.0))
    return {"R": R, "t": t, "rmse": rmse, "n_corr": n_corr}


@pytest.mark.parametrize("case", ["stride1", "stride4", "bank"])
def test_icp_point2point_matches_pre_kernel_loop(case):
    """icp_point2point (the update op: Horn by the fixed-sweep Jacobi)
    against a copy of its pre-op loop (Horn by eigh) on the same frames:
    three clouds, one of them with fewer than 3 pairs within the gate
    (its pose kept), at coarse stride 1 and 4 and as a flip bank (each
    frame repeated under 4 start rotations, B x H = 12). Both reach the
    same correspondences each step; the eigensolvers differ by float32
    rounding: the JAX parity test's tolerances (R 1e-4, t 1e-3), n_corr
    exact."""
    rng = np.random.default_rng(5)
    bsz, m, n = 3, 400, 160
    cad = (rng.normal(size=(bsz, m, 3)) * [4.0, 3.0, 2.0]).astype(np.float32)
    cad_valid = np.arange(m)[None].repeat(bsz, 0) < 380
    pc = np.zeros((bsz, n, 3), np.float32)
    R0, t0 = [], []
    for f in range(bsz):
        R_gt = _rotation(rng)
        t_gt = np.array([1.0, 2.0, 60.0], np.float32)
        sel = rng.permutation(380)[:150]
        pc[f, :150] = (cad[f, sel] @ R_gt.T + t_gt
                       + 0.01 * rng.normal(size=(150, 3)))
        a = np.radians(4.0)
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]])
        R0.append(R_gt @ Rz)
        t0.append(t_gt + np.array([0.3, -0.2, 0.4]))
    pc_valid = np.arange(n)[None].repeat(bsz, 0) < 150
    pc[2, :150] += 50.0          # frame 2: no pair within the gate
    R0, t0 = np.asarray(R0, np.float32), np.asarray(t0, np.float32)
    stride = 4 if case == "stride4" else 1
    if case == "bank":
        bank = [np.eye(3), np.diag([1.0, -1.0, -1.0]),
                np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
        R0 = np.stack([r @ b for r in R0 for b in bank]).astype(np.float32)
        t0 = t0.repeat(4, 0)
        cad, cad_valid, pc, pc_valid = (x.repeat(4, 0) for x in
                                        (cad, cad_valid, pc, pc_valid))
    # the cloud onto the CAD from the inverse pose, as icp_cloud_to_model
    Rinv = np.transpose(R0, (0, 2, 1))
    tinv = -np.einsum("bij,bj->bi", Rinv, t0).astype(np.float32)
    args = [_t(x) for x in (pc, pc_valid, cad, cad_valid, Rinv, tinv)]
    gate = _t(np.full(len(R0), 2.0, np.float32))
    got = solvers.icp_point2point(*args, max_corr_dist=gate, max_iter=12,
                                  coarse_stride=stride)
    want = _icp_inline(*args, max_corr_dist=gate, max_iter=12,
                       coarse_stride=stride)
    kept = torch.as_tensor(np.arange(len(R0)) // (4 if case == "bank" else 1)
                           == 2)
    assert torch.equal(got["R"][kept], args[4][kept])
    assert torch.equal(got["t"][kept], args[5][kept])
    assert (got["n_corr"][~kept] > 100).all()
    np.testing.assert_allclose(got["R"].numpy(), want["R"].numpy(), atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), want["t"].numpy(), atol=1e-3)
    np.testing.assert_array_equal(got["n_corr"].numpy(),
                                  want["n_corr"].numpy())
    np.testing.assert_allclose(got["rmse"].numpy(), want["rmse"].numpy(),
                               rtol=1e-3)
