"""The spatial filter at any k and pruning schedule, and the two kernels
it runs at that k, on the CPU against the JAX package on the same numpy
inputs: the filter at k = 3, 8 and 24 with a non-default `taus` (the
port's one layout against JAX's PC-major path and its rank-major Pallas
path in interpret mode), the masked top-k plain version at k = 1, 3, 8, 16,
24, 32 (rows with fewer valid columns than k included) and the k-prefix
rule the card's list instances rest on, and the rank-major sums at k = 1
to 32 with their chunk and segment planning."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu import solvers as jax_solvers
from pose6d_tpu.ops import nn as jax_nn
from pose6d_tpu.ops.pallas import (consistency_sum_rank_major as jax_rm,
                                   masked_topk_cdist as jax_topk)
from pose6d_tpu_torch import solvers
from pose6d_tpu_torch.ops.kernels import (LAUNCHES,
                                          consistency_sum_rank_major,
                                          masked_topk_cdist,
                                          masked_topk_cdist_plain)
from pose6d_tpu_torch.ops.kernels._build import segment_tiles
from pose6d_tpu_torch.ops.kernels import cdist as cdist_module
from pose6d_tpu_torch.ops.kernels.cdist import (KPASS_MAX_K, TOPK_INSTANCES,
                                                topk_instance)
from pose6d_tpu_torch.ops.kernels.consistency import (
    RM_COL_TILE, RM_RANKS_PER_BLOCK, RM_ROW_TILE, rank_major_chunks,
    rank_major_segments)

from test_torch_filter_pcmajor import _filter_inputs

torch.set_num_threads(2)

# three plain rounds, then the (tight, loose) final round
TAUS = (0.4, 0.25, 0.12, 0.07, 0.09)


def _t(x):
    return torch.as_tensor(np.asarray(x))[None]   # add the frame axis


# the port sums rank-major only; the id keeps naming its layout
@pytest.mark.parametrize("port_layout", ["rank_major"])
@pytest.mark.parametrize("jax_layout", ["rank_major", "pc_major"])
@pytest.mark.parametrize("k", [3, 8, 24])
def test_filter_any_k_and_taus_matches_jax(k, jax_layout, port_layout):
    """Well-separated geometry (tests/test_torch_filter_pcmajor.py): the
    pairs and the survivor mask exactly equal, whichever layout the JAX
    package takes."""
    args, diam = _filter_inputs()
    jp, jv = jax_solvers.spatial_filtering_fmap2pointmap(
        *(jnp.asarray(a) for a in args), diam, k=k, taus=TAUS,
        rank_major=jax_layout == "rank_major")
    tp, tv = solvers.spatial_filtering_fmap2pointmap(
        *(_t(a) for a in args), torch.tensor([diam]), k=k, taus=TAUS)
    v2 = len(args[6])
    assert tp.shape == (1, 2, v2 * k) and tv.shape == (1, v2 * k)
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < k * v2


def test_filter_schedule_reaches_every_round():
    """A schedule of n entries runs n - 1 rounds of means (n - 2 plain,
    one final); fewer than two entries raise."""
    args, diam = _filter_inputs()
    targs = [_t(a) for a in args]
    *_, means = solvers.spatial_filtering_fmap2pointmap(
        *targs, torch.tensor([diam]), k=3, taus=TAUS, return_means=True)
    assert len(means) == len(TAUS) - 1
    with pytest.raises(ValueError, match="taus"):
        solvers.spatial_filtering_fmap2pointmap(
            *targs, torch.tensor([diam]), k=3, taus=(0.1,))


def _cdist_inputs(seed, n, m, c, n_valid):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, c)).astype(np.float32)
    b = rng.normal(size=(m, c)).astype(np.float32)
    valid = np.zeros(m, bool)
    valid[rng.permutation(m)[:n_valid]] = True
    return a, b, valid


@pytest.mark.parametrize("n_valid", [40, 5])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 24, 32])
def test_topk_plain_any_k_matches_jax(k, n_valid):
    """Against the XLA path (the k-pass up to k = 8, lax.top_k above)
    and the Pallas kernel (interpret mode) at the same k, including rows
    with fewer valid columns (5) than k, where the XLA path gives
    d2 = 1e9 and index 0 (k-pass) or the masked columns (top_k). The
    Pallas kernel fills such slots with d2 + 1e9 instead, so it is held
    only on the slots a valid column fills (every slot of a row with at
    least k valid columns)."""
    a, b, valid = _cdist_inputs(2, 64, 48, 30, n_valid)
    td, ti = masked_topk_cdist(_t(a), _t(b), _t(valid), k=k)
    xd, xi = jax_nn.topk_valid(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(valid), k=k)
    pd, pi = jax_topk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                      k=k, block_n=64, interpret=True)
    assert ti.shape == (1, 64, k)
    for ref_d, ref_i in ((xd, xi), (pd, pi)):
        live = min(k, n_valid)
        # indices exact where a valid column exists (well-separated
        # inputs); d2 to f32 summation order; the 1e9 fill exact
        np.testing.assert_array_equal(ti[0, :, :live].numpy(),
                                      np.asarray(ref_i)[:, :live])
        np.testing.assert_allclose(td[0, :, :live].numpy(),
                                   np.asarray(ref_d)[:, :live], rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(xi))
    if n_valid < k:
        assert (td[0, :, n_valid:] == 1e9).all()
        # the k-pass repeats column 0; lax.top_k (k > 8) takes the
        # masked columns in increasing order
        fill = (np.zeros(k - n_valid) if k <= KPASS_MAX_K
                else np.flatnonzero(~valid)[:k - n_valid])
        assert (ti[0, :, n_valid:].numpy() == fill).all()


@pytest.mark.parametrize("n_valid", [40, 5, 0])
def test_top_k_fill_of_the_kernel_list(n_valid):
    """Above k = 8 the wrapper rewrites the kernel's (1e9, 0) slots as
    lax.top_k fills them: applied to the k-pass list (what the kernel
    writes), it gives the plain top-k exactly."""
    a, b, valid = _cdist_inputs(4, 32, 48, 3, n_valid)
    args = (torch.as_tensor(a)[None], torch.as_tensor(b)[None],
            torch.as_tensor(valid)[None])
    for k in (9, 12, 16):
        kd, _ = cdist_module.masked_topk_cdist_plain(*args, KPASS_MAX_K)
        # the kernel's list at k: the k-pass carried on past 8
        cur = torch.where(args[2][:, None, :],
                          cdist_module.pairwise_sqdist(args[0], args[1]),
                          torch.tensor(1e9))
        ds, idxs = [], []
        for _ in range(k):
            i = torch.argmin(cur, dim=-1, keepdim=True)
            ds.append(torch.gather(cur, -1, i)[..., 0])
            idxs.append(i[..., 0].to(torch.int32))
            cur = cur.scatter(-1, i, 1e9)
        d2, idx = torch.stack(ds, -1), torch.stack(idxs, -1)
        assert torch.equal(d2[..., :KPASS_MAX_K], kd)
        pd, pi = masked_topk_cdist_plain(*args, k)
        assert torch.equal(d2, pd)
        assert torch.equal(cdist_module._top_k_fill(d2, idx, args[2]), pi)


@pytest.mark.parametrize("n_valid", [40, 5, 0])
def test_topk_is_the_prefix_of_every_longer_topk(n_valid):
    """The card launches the smallest instance K >= k and keeps k
    columns: the plain k-pass's top-k equals the k-prefix of its top-K
    bit for bit, ties and the (1e9, 0) fill included."""
    a, b, valid = _cdist_inputs(3, 40, 60, 3, n_valid)
    b[30:] = b[:30]                      # exact ties across columns
    args = (torch.as_tensor(a)[None], torch.as_tensor(b)[None],
            torch.as_tensor(valid)[None])
    for k in range(1, TOPK_INSTANCES[-1] + 1):
        inst = topk_instance(k)
        assert inst in TOPK_INSTANCES and inst >= k
        d, i = masked_topk_cdist_plain(*args, k)
        dk, ik = masked_topk_cdist_plain(*args, inst)
        assert torch.equal(d, dk[..., :k]) and torch.equal(i, ik[..., :k])
    # above the longest list the kernel's wide path serves k itself
    assert [topk_instance(k) for k in (17, 24, 32, 64)] == [17, 24, 32, 64]


@pytest.mark.parametrize("k", [1, 3, 8, 16, 24, 32])
def test_rank_major_plain_any_k_matches_pallas(k):
    rng = np.random.default_rng(20 + k)
    v2 = 64
    ca = (rng.normal(size=(v2 * k, 3)) * 2).astype(np.float32)
    pc = (rng.normal(size=(v2, 3)) * 2).astype(np.float32)
    w = (rng.random(v2 * k) > 0.3).astype(np.float32)
    dpc = np.linalg.norm(pc[:, None] - pc[None], axis=-1).astype(np.float32)
    ref = jax_rm(jnp.asarray(ca), jnp.asarray(dpc), jnp.asarray(w), v2=v2,
                 block_i=64, block_j=64, interpret=True)
    before = dict(LAUNCHES)
    out = consistency_sum_rank_major(_t(ca), _t(dpc), _t(w), v2)
    assert LAUNCHES == before             # a CPU tensor never launches
    # sums of up to ~700 terms of size ~5: f32 summation order
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-3)


def test_rank_major_chunks_cover_every_rank():
    """ceil(k / 5) chunks of ceil(k / chunks) ranks (the kernel's
    chunk_width) hold each of the k ranks once, at most 5 a block, at
    any k."""
    for k in range(1, 65):
        chunks = rank_major_chunks(k)
        width = -(-k // chunks)
        assert width <= RM_RANKS_PER_BLOCK
        ranks = [c * width + r for c in range(chunks) for r in range(width)
                 if c * width + r < k]
        assert ranks == list(range(k))
    assert rank_major_chunks(5) == 1 and rank_major_chunks(16) == 4
    assert rank_major_chunks(24) == 5 and rank_major_chunks(32) == 7


@pytest.mark.parametrize("k", [1, 3, 8, 16, 24, 32])
@pytest.mark.parametrize("bsz,v2", [(1, 2048), (16, 2048), (3, 2000)])
def test_rank_major_segments_at_any_k(bsz, v2, k):
    tiles = -(-v2 // RM_ROW_TILE)
    blocks = -(-v2 // RM_COL_TILE) * rank_major_chunks(k) * bsz
    for sms, per_sm in ((132, 2), (7, 1)):
        s = rank_major_segments(bsz, v2, sms, per_sm, k)
        assert 1 <= s <= tiles
        walked = sorted(t for g in range(s)
                        for t in segment_tiles(tiles, s, g))
        assert walked == list(range(tiles))
        assert blocks * s >= min(2 * sms, blocks * tiles)
    assert rank_major_segments(bsz, v2, 132, 2, 5) == \
        rank_major_segments(bsz, v2, 132, 2)
