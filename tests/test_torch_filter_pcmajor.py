"""The port's PC-major spatial filter on the CPU against the JAX package
on the same numpy inputs: the masked consistency sums (against the
Pallas kernel in interpret mode), the exact PC-major filter, its
row_subsample screening path, the naive nearest-embedding map, and the
port's PC-major path against its own rank-major one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu import solvers as jax_solvers
from pose6d_tpu.ops.pallas import masked_consistency_sum as jax_mcs
from pose6d_tpu_torch import solvers
from pose6d_tpu_torch.ops.kernels import (LAUNCHES, masked_consistency_sum,
                                          masked_consistency_sum_plain)

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


def test_pc_major_filter_matches_jax():
    args, diam = _filter_inputs()
    jp, jv = jax_solvers.spatial_filtering_fmap2pointmap(
        *(jnp.asarray(a) for a in args), diam, k=5, rank_major=False)
    tp, tv = solvers.spatial_filtering_fmap2pointmap(
        *(_t(a) for a in args), torch.tensor([diam]), rank_major=False)
    # well-separated geometry: pairs and survivor masks exactly equal
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < 5 * len(args[6])


def test_pc_major_matches_rank_major():
    """The two layouts of the port's filter, batched over two frames,
    agree exactly here (the JAX package holds its own two equal on the
    same construction)."""
    frames = [_filter_inputs(seed) for seed in (11, 12)]
    args = [torch.stack([torch.as_tensor(f[0][i]) for f in frames])
            for i in range(7)]
    diam = torch.tensor([f[1] for f in frames])
    p_pc, v_pc, means = solvers.spatial_filtering_fmap2pointmap(
        *args, diam, rank_major=False, return_means=True)
    p_rm, v_rm = solvers.spatial_filtering_fmap2pointmap(*args, diam)
    np.testing.assert_array_equal(p_pc.numpy(), p_rm.numpy())
    np.testing.assert_array_equal(v_pc.numpy(), v_rm.numpy())
    assert len(means) == 3 and means[0].shape == v_pc.shape


@pytest.mark.parametrize("row_subsample", [128, 100])
def test_row_subsample_matches_jax(row_subsample):
    """The screening path (plain PyTorch, as it is plain XLA in JAX):
    stride P // row_subsample, the first row_subsample strided rows."""
    args, diam = _filter_inputs(seed=13)
    jp, jv = jax_solvers.spatial_filtering_fmap2pointmap(
        *(jnp.asarray(a) for a in args), diam, k=5,
        row_subsample=row_subsample, rank_major=False)
    before = dict(LAUNCHES)
    tp, tv = solvers.spatial_filtering_fmap2pointmap(
        *(_t(a) for a in args), torch.tensor([diam]), rank_major=False,
        row_subsample=row_subsample)
    assert LAUNCHES == before
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="PC-major"):
        solvers.spatial_filtering_fmap2pointmap(
            *(_t(a) for a in args), torch.tensor([diam]),
            row_subsample=row_subsample)


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
