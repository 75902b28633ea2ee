"""The port's spatial filter on the CPU against the JAX package's
PC-major path on the same numpy inputs: the masked consistency sums
(against the Pallas kernel in interpret mode; ZoomOut's gate runs them),
the filter's pairs, survivors and per-round means, and the naive
nearest-embedding map."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu import solvers as jax_solvers
from pose6d_tpu.ops import nn as jax_nn
from pose6d_tpu.ops.pallas import masked_consistency_sum as jax_mcs
from pose6d_tpu.solvers import fmap2pointmap as jax_fmap
from pose6d_tpu_torch import solvers
from pose6d_tpu_torch.ops.kernels import (LAUNCHES, masked_consistency_sum,
                                          masked_consistency_sum_plain)
from pose6d_tpu_torch.solvers.fmap2pointmap import TAUS

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))[None]   # add the frame axis


def _filter_inputs(seed=11, v1=256, v2=128, k=30):
    """Well-separated random geometry: the construction of
    tests/test_torch_solvers.py's rank-major parity test (and of
    tests/test_solvers.py::TestRankMajorBranchParity)."""
    rng = np.random.default_rng(seed)
    cad = (rng.normal(size=(v1, 3)) * 2).astype(np.float32)
    perm = rng.permutation(v1)[:v2]
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rot = (q * np.linalg.det(q)).astype(np.float32)
    pc = (cad[perm] @ rot.T + rng.normal(size=3)).astype(np.float32)
    evecs_x = np.linalg.qr(rng.normal(size=(v1, k)))[0].astype(np.float32)
    evecs_y = evecs_x[perm].copy()
    bad = rng.choice(v2, 40, replace=False)
    evecs_y[bad] = np.linalg.qr(rng.normal(size=(v1, k)))[0][:len(bad)]
    C = (np.eye(k) + 0.01 * rng.normal(size=(k, k))).astype(np.float32)
    diam = float(np.linalg.norm(cad.max(0) - cad.min(0)))
    x_valid = np.arange(v1) < 250
    y_valid = np.ones(v2, bool)
    y_valid[rng.choice(v2, 9, replace=False)] = False
    return (C, evecs_x, evecs_y, cad, pc, x_valid, y_valid), diam


def test_masked_consistency_plain_matches_pallas():
    rng = np.random.default_rng(4)
    p = 384
    ca = (rng.normal(size=(p, 3)) * 2).astype(np.float32)
    cb = (rng.normal(size=(p, 3)) * 2 + 100).astype(np.float32)
    w = (rng.random(p) > 0.3).astype(np.float32)
    ref = jax_mcs(jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(w),
                  block_i=128, block_j=128, interpret=True)
    before = dict(LAUNCHES)
    out = masked_consistency_sum(_t(ca), _t(cb), _t(w))
    assert LAUNCHES == before             # a CPU tensor never launches
    # both expand |x - y|^2 as x^2 - 2xy + y^2: with the PC side ~100 cm
    # out that cancels to ~eps * 1e4 = 1e-3 in d^2 (3e-2 in d for the
    # nearest pairs); sums of ~270 terms of size ~5 in another order
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-2)


def test_masked_consistency_plain_matches_float64():
    """The plain version against the direct-difference definition in
    float64, over two frames (one with every row weight 0)."""
    rng = np.random.default_rng(5)
    ca = (rng.normal(size=(2, 200, 3)) * 3).astype(np.float32)
    cb = (rng.normal(size=(2, 200, 3)) * 3).astype(np.float32)
    w = (rng.random((2, 200)) > 0.5).astype(np.float32)
    w[1] = 0.0
    out = masked_consistency_sum_plain(*(torch.as_tensor(x)
                                         for x in (ca, cb, w)))
    da = np.linalg.norm(ca[:, :, None].astype(np.float64) - ca[:, None],
                        axis=-1)
    db = np.linalg.norm(cb[:, :, None].astype(np.float64) - cb[:, None],
                        axis=-1)
    ref = np.einsum("bi,bij->bj", w, np.abs(da - db))
    # the f32 expansion on coordinates of ~10: ~eps * 100 in d^2; the
    # zero-distance diagonal term comes out as sqrt of that (~4e-3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=2e-2)
    assert (out[1] == 0).all()


# the default plain rounds, then a final (tight, loose) pair that keeps
# survivors at every k on this random geometry
TAUS_LOOSE_FINAL = (0.3, 0.15, 0.08, 0.1)


@pytest.mark.parametrize("k", [3, 5, 8])
def test_filter_matches_jax_pc_major(k):
    """The port's filter (rank-major sums), batched over two frames,
    against the JAX package's PC-major path (rank_major=False) on each
    frame's inputs."""
    frames = [_filter_inputs(seed) for seed in (11, 12)]
    args = [torch.stack([torch.as_tensor(f[0][i]) for f in frames])
            for i in range(7)]
    tp, tv = solvers.spatial_filtering_fmap2pointmap(
        *args, torch.tensor([f[1] for f in frames]), k=k,
        taus=TAUS_LOOSE_FINAL)
    for b, (fargs, diam) in enumerate(frames):
        jp, jv = jax_solvers.spatial_filtering_fmap2pointmap(
            *(jnp.asarray(a) for a in fargs), diam, k=k,
            taus=TAUS_LOOSE_FINAL, rank_major=False)
        # well-separated geometry: pairs and survivor masks exactly equal
        np.testing.assert_array_equal(tp[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(jv))
        assert 0 < int(tv[b].sum()) < k * len(fargs[6])


def _jax_pc_major_means(args, diam, k):
    """Each pruning round's consistency means of the JAX package's
    PC-major path: its schedule run on its own mean, recorded."""
    C, evecs_x, evecs_y, cad, pc, x_valid, y_valid = (jnp.asarray(a)
                                                      for a in args)
    _, topk = jax_nn.topk_valid(evecs_y, evecs_x @ C.T, x_valid, k=k)
    cad_idx = topk.astype(jnp.int32).reshape(-1)
    pc_idx = jnp.repeat(jnp.arange(pc.shape[0], dtype=jnp.int32), k)
    ca, cb = cad[cad_idx], pc[pc_idx]
    means = []

    def cmean(v):
        means.append(np.asarray(jax_fmap._consistency_mean(ca, cb, v)))
        return means[-1]

    jax_fmap._prune_schedule(cmean, jnp.repeat(y_valid, k), TAUS, diam)
    return means


@pytest.mark.parametrize("k", [3, 5, 8])
def test_filter_means_match_jax_pc_major(k):
    """return_means, round by round, against the JAX package's PC-major
    means: the port sums rank-major over a PC distance table, JAX sums
    direct differences pair by pair, both in float32."""
    args, diam = _filter_inputs()
    *_, means = solvers.spatial_filtering_fmap2pointmap(
        *(_t(a) for a in args), torch.tensor([diam]), k=k,
        return_means=True)
    ref = _jax_pc_major_means(args, diam, k)
    assert len(means) == len(ref) == len(TAUS) - 1
    for m, r in zip(means, ref):
        assert m.shape == (1, k * len(args[6]))
        # means of up to V2 * k terms summed in two orders, the PC side
        # from a distance table against direct differences: ~10 f32 ulps
        # apart at k = 8
        np.testing.assert_allclose(m[0].numpy(), r, rtol=1e-5, atol=0)


def test_naive_fmap2pointmap_matches_jax():
    args, _ = _filter_inputs(seed=14)
    C, evecs_x, evecs_y, _, _, x_valid, y_valid = args
    jp, jv = jax_solvers.naive_fmap2pointmap(
        *(jnp.asarray(a) for a in (C, evecs_x, evecs_y, x_valid, y_valid)))
    tp, tv = solvers.naive_fmap2pointmap(
        *(_t(a) for a in (C, evecs_x, evecs_y, x_valid, y_valid)))
    # nearest neighbours in a 30-d embedding of random rows: separated
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    assert tp.dtype == torch.int32
