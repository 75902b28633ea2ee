"""The port's kernel modules on the CPU: each plain version (what the
wrapper runs for a CPU tensor) against the JAX package's function on
the same numpy inputs. Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them."""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.models.attention import MultiHeadedAttention as JaxMHA
from pose6d_tpu.ops import nn as jax_nn
from pose6d_tpu.solvers import kabsch as jax_kabsch
from pose6d_tpu.ops.pallas import (consistency_sum_rank_major as jax_rm,
                                   masked_argmin_cdist as jax_argmin,
                                   masked_consistency_sum as jax_mcs,
                                   masked_topk_cdist as jax_topk)
from pose6d_tpu_torch.models.attention import MultiHeadedAttention
from pose6d_tpu_torch.models.weights import (flax_from_state_dict,
                                             state_dict_from_flax)
from pose6d_tpu_torch.ops import nn as torch_nn
from pose6d_tpu_torch.ops.kernels._build import segment_tiles
from pose6d_tpu_torch.ops.kernels.attention import (
    FLASH_BWD_ROWS, FLASH_BWD_TILE, FLASH_KEY_TILE, FLASH_MAX_SEGMENT_TILES,
    flash_backward_segments, flash_cross_attention_plain,
    flash_queries_per_block, flash_segments)
from pose6d_tpu_torch.ops.kernels.consistency import (
    PCM_COL_TILE, PCM_ROW_TILE, RM_COL_TILE, RM_ROW_TILE,
    consistency_segments, rank_major_segments)
from pose6d_tpu_torch.ops.kernels.icp import (icp_kabsch_update,
                                              rotation_from_h_jacobi)
from pose6d_tpu_torch.ops.kernels.ransac import (
    RANSAC_HYP_TILE, RANSAC_PAIR_TILE, ransac_inlier_counts, ransac_segments)
from pose6d_tpu_torch.ops.kernels import (LAUNCHES, consistency_sum_rank_major,
                                          flash_cross_attention,
                                          flash_cross_attention_backward,
                                          masked_argmin_cdist,
                                          masked_consistency_sum,
                                          masked_consistency_sum_plain,
                                          masked_topk_cdist)

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))[None]   # add the frame axis


def _cdist_inputs(seed, n, m, c, n_valid):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, c)).astype(np.float32)
    b = rng.normal(size=(m, c)).astype(np.float32)
    valid = np.zeros(m, bool)
    valid[rng.permutation(m)[:n_valid]] = True
    return a, b, valid


@pytest.mark.parametrize("c", [3, 30, 65, 96, 128])
def test_argmin_plain_matches_pallas(c):
    a, b, valid = _cdist_inputs(0, 256, 192, c, 150)
    jd, ji = jax_argmin(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                        block_n=128, interpret=True)
    td, ti = masked_argmin_cdist(_t(a), _t(b), _t(valid))
    # random normal inputs: nearest neighbours are well separated, so
    # indices must agree exactly; d2 differs by f32 summation order only
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("c", [3, 30, 65, 96, 128])
def test_topk_plain_matches_pallas(c):
    a, b, valid = _cdist_inputs(1, 128, 96, c, 70)
    jd, ji = jax_topk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                      k=5, block_n=128, interpret=True)
    td, ti = masked_topk_cdist(_t(a), _t(b), _t(valid), k=5)
    # exact indices on well-separated inputs; d2 to f32 summation order
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n_valid", [40, 3])
def test_topk_valid_matches_jax_kpass(n_valid):
    """Against the XLA k-pass, including rows with fewer than k valid
    columns (3 < k = 5), where it returns d2 = 1e9 and index 0."""
    a, b, valid = _cdist_inputs(2, 64, 48, 30, n_valid)
    jd, ji = jax_nn.topk_valid(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(valid), k=5)
    td, ti = torch_nn.topk_valid(_t(a), _t(b), _t(valid), k=5)
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    # the 1e9 fill is exact; real distances agree to f32 summation order
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    if n_valid < 5:
        assert (ti[0, :, n_valid:] == 0).all()
        assert (td[0, :, n_valid:] == 1e9).all()


def _tie_inputs(seed, n, m, c, n_valid):
    """Every b row has an exact copy m/2 columns later, and the first 16
    rows come in adjacent equal pairs: exact d2 ties, which the kernel's
    column split puts in different lanes, segments and blocks."""
    a, b, valid = _cdist_inputs(seed, n, m, c, n_valid)
    b[1:16:2] = b[0:16:2]
    b[m // 2:] = b[:m // 2]
    return a, b, valid


def _jax_cdist(kernel, ref, a, b, valid):
    """The JAX package's (d2 (N, k), idx (N, k)) through the Pallas
    kernel in interpret mode or through the XLA path of ops/nn.py."""
    a, b, valid = jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid)
    if kernel == "argmin":
        d, i = (jax_argmin(a, b, valid, block_n=128, interpret=True)
                if ref == "pallas" else jax_nn.nearest_valid(a, b, valid))
        return np.asarray(d)[:, None], np.asarray(i)[:, None]
    d, i = (jax_topk(a, b, valid, k=5, block_n=128, interpret=True)
            if ref == "pallas" else jax_nn.topk_valid(a, b, valid, k=5))
    return np.asarray(d), np.asarray(i)


def _port_cdist(kernel, a, b, valid):
    if kernel == "argmin":
        d, i = masked_argmin_cdist(a, b, valid)
        return d[..., None], i[..., None]
    return masked_topk_cdist(a, b, valid, k=5)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("kernel", ["argmin", "topk"])
def test_exact_ties_go_to_lower_index(kernel, ref):
    c = 3 if kernel == "argmin" else 30
    m = 96
    a, b, valid = _tie_inputs(10, 128, m, c, 80)
    jd, ji = _jax_cdist(kernel, ref, a, b, valid)
    td, ti = _port_cdist(kernel, _t(a), _t(b), _t(valid))
    td, ti = td[0].numpy(), ti[0].numpy()
    # indices exact (equal rows give bit-equal d2 on both sides, and the
    # distinct rows are well separated); d2 to f32 summation order
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    # the later copy of a column is taken only after its valid twin
    twin = np.where(ti >= m // 2, ti - m // 2, -1)
    for r, s in zip(*np.nonzero((twin >= 0) & valid[np.maximum(twin, 0)])):
        assert twin[r, s] in ti[r, :s], (r, s, ti[r])
    pair = (ti < 16) & (ti % 2 == 1) & valid[np.maximum(ti - 1, 0)]
    for r, s in zip(*np.nonzero(pair)):
        assert ti[r, s] - 1 in ti[r, :s], (r, s, ti[r])


@pytest.mark.parametrize("kernel", ["argmin", "topk"])
def test_row_without_valid_column_matches_xla(kernel):
    """A frame with no valid column, against the XLA path only: the
    Pallas kernel adds +BIG to the expansion instead of replacing it, so
    its d2 there is 1e9 + |a - b|^2 rounded in f32 and its index is the
    nearest masked column, not the (1e9, 0) that the XLA k-pass and the
    port return."""
    c = 3 if kernel == "argmin" else 30
    a, b, valid = _cdist_inputs(11, 64, 48, c, 0)
    jd, ji = _jax_cdist(kernel, "xla", a, b, valid)
    td, ti = _port_cdist(kernel, _t(a), _t(b), _t(valid))
    # exact: no distance enters, every slot is the fill
    np.testing.assert_array_equal(ti[0].numpy(), ji)
    np.testing.assert_array_equal(td[0].numpy(), jd)
    assert (td == 1e9).all() and (ti == 0).all()


@pytest.mark.parametrize("kernel", ["argmin", "topk"])
def test_batched_frames_match_per_frame_jax(kernel):
    """Three frames in one call with 40, 3 and 0 valid columns, against
    one call of the JAX XLA path per frame."""
    c = 3 if kernel == "argmin" else 30
    frames = [_cdist_inputs(12 + f, 64, 48, c, nv)
              for f, nv in enumerate((40, 3, 0))]
    a, b, valid = (torch.as_tensor(np.stack(x)) for x in zip(*frames))
    td, ti = _port_cdist(kernel, a, b, valid)
    for f, (fa, fb, fv) in enumerate(frames):
        jd, ji = _jax_cdist(kernel, "xla", fa, fb, fv)
        np.testing.assert_array_equal(ti[f].numpy(), ji)
        # the 1e9 fill is exact; real distances to f32 summation order
        np.testing.assert_allclose(td[f].numpy(), jd, rtol=1e-4, atol=1e-4)


def test_nearest_valid_matches_jax():
    a, b, valid = _cdist_inputs(3, 100, 80, 3, 60)
    jd, ji = jax_nn.nearest_valid(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(valid))
    td, ti = torch_nn.nearest_valid(_t(a), _t(b), _t(valid))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    # f32 summation order only
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)


def test_consistency_plain_matches_pallas():
    rng = np.random.default_rng(4)
    v2, k = 128, 3
    ca = (rng.normal(size=(v2 * k, 3)) * 2).astype(np.float32)
    pc = (rng.normal(size=(v2, 3)) * 2).astype(np.float32)
    w = (rng.random(v2 * k) > 0.3).astype(np.float32)
    dpc = np.linalg.norm(pc[:, None] - pc[None], axis=-1).astype(np.float32)
    ref = jax_rm(jnp.asarray(ca), jnp.asarray(dpc), jnp.asarray(w), v2=v2,
                 block_i=64, block_j=128, interpret=True)
    out = consistency_sum_rank_major(_t(ca), _t(dpc), _t(w), v2)
    # sums of ~270 terms of size ~5: f32 summation-order differences
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("weights", ["prefix", "dead_rank"])
def test_consistency_plain_matches_pallas_serve_weights(weights):
    """The serve path's weights: live rows a prefix of each rank group
    (96 of 128 here, as 622 or 2000 of 2048 on the card), and with one
    rank whose rows are all dead; K = 5 ranks, as the kernel takes."""
    rng = np.random.default_rng(13)
    v2, k = 128, 5
    ca = (rng.normal(size=(v2 * k, 3)) * 2).astype(np.float32)
    pc = (rng.normal(size=(v2, 3)) * 2).astype(np.float32)
    w = np.zeros((k, v2), np.float32)
    w[:, :96] = 1.0
    if weights == "dead_rank":
        w[2] = 0.0
    w = w.reshape(-1)
    dpc = np.linalg.norm(pc[:, None] - pc[None], axis=-1).astype(np.float32)
    ref = jax_rm(jnp.asarray(ca), jnp.asarray(dpc), jnp.asarray(w), v2=v2,
                 block_i=64, block_j=128, interpret=True)
    out = consistency_sum_rank_major(_t(ca), _t(dpc), _t(w), v2)
    # sums of <= 480 terms of size ~5: f32 summation-order differences
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


def _width_tolerance(ref, *points):
    """Tolerance of a consistency sum at endpoint width C against the
    Pallas kernel: f32 sums in another order (1e-4 of the largest sum),
    and per column the pair with itself, whose |a|^2 - 2 a.a + |a|^2 both
    sides round differently: up to sqrt((C + 5) eps 2 |a|^2) in d (the
    expansion's bound; the sums of C products, then two additions)."""
    c = points[0].shape[-1]
    n2 = max(float((x.astype(np.float64) ** 2).sum(-1).max()) for x in points)
    return 1e-4 * np.abs(ref).max() + 2 * np.sqrt((c + 5) * 2.0 ** -24
                                                  * 2 * n2)


@pytest.mark.parametrize("c", [1, 2, 4, 8, 30])
def test_rank_major_any_width_matches_pallas(c):
    """consistency_sum_rank_major at endpoint width C (the card's
    any-width instance; on the CPU its plain version) against the Pallas
    kernel in interpret mode, which pads C to 8; k = 3 ranks, 70 % of the
    rows live."""
    rng = np.random.default_rng(30 + c)
    v2, k = 128, 3
    ca = (rng.normal(size=(v2 * k, c)) * 2).astype(np.float32)
    pc = (rng.normal(size=(v2, c)) * 2).astype(np.float32)
    w = (rng.random(v2 * k) > 0.3).astype(np.float32)
    dpc = np.linalg.norm(pc[:, None] - pc[None], axis=-1).astype(np.float32)
    ref = np.asarray(jax_rm(jnp.asarray(ca), jnp.asarray(dpc), jnp.asarray(w),
                            v2=v2, block_i=64, block_j=128, interpret=True))
    before = dict(LAUNCHES)
    out = consistency_sum_rank_major(_t(ca), _t(dpc), _t(w), v2)
    assert LAUNCHES == before and out.shape == (1, v2 * k)
    np.testing.assert_allclose(out[0].numpy(), ref, rtol=0,
                               atol=_width_tolerance(ref, ca))


@pytest.mark.parametrize("c", [1, 2, 4, 8, 30])
def test_masked_consistency_any_width_matches_pallas(c):
    """masked_consistency_sum at endpoint width C against the Pallas
    kernel in interpret mode (which pads C to 8), on two frames: the PC
    side a rotation of the CAD side moved 10 along the last axis, half
    of the pairs consistent, 70 % of the rows live, the second frame
    with a dead half."""
    rng = np.random.default_rng(40 + c)
    p = 320
    rot = np.linalg.qr(rng.normal(size=(c, c)))[0]
    ca = (rng.normal(size=(2, p, c)) * 3).astype(np.float32)
    cb = ca @ rot.T + np.eye(c)[-1] * 10
    cb = np.where(rng.random((2, p, 1)) < 0.5, cb,
                  cb + rng.normal(size=(2, p, c))).astype(np.float32)
    w = (rng.random((2, p)) > 0.3).astype(np.float32)
    w[1, p // 2:] = 0.0
    before = dict(LAUNCHES)
    out = masked_consistency_sum(*(torch.as_tensor(x) for x in (ca, cb, w)))
    assert LAUNCHES == before and out.shape == (2, p)
    for f in range(2):
        ref = np.asarray(jax_mcs(jnp.asarray(ca[f]), jnp.asarray(cb[f]),
                                 jnp.asarray(w[f]), block_i=64, block_j=64,
                                 interpret=True))
        np.testing.assert_allclose(out[f].numpy(), ref, rtol=0,
                                   atol=_width_tolerance(ref, ca[f], cb[f]))


def _each_tile_once(tiles, segments):
    walked = sorted(t for s in range(segments)
                    for t in segment_tiles(tiles, segments, s))
    return walked == list(range(tiles))


# (SMs, blocks per SM): the H100 with the kernels' occupancies, and a
# small card
CARDS = [(132, 2), (132, 3), (7, 1)]


@pytest.mark.parametrize("bsz,v2", [(1, 2048), (16, 2048), (1, 2000),
                                    (3, 2000), (2, 37), (16, 5)])
def test_rank_major_segments_cover_every_row_tile(bsz, v2):
    tiles = -(-v2 // RM_ROW_TILE)
    col_blocks = -(-v2 // RM_COL_TILE) * bsz
    for sms, per_sm in CARDS:
        s = rank_major_segments(bsz, v2, sms, per_sm)
        assert 1 <= s <= tiles
        assert _each_tile_once(tiles, s)
        # two blocks on every SM, as far as the row tiles allow
        assert col_blocks * s >= min(2 * sms, col_blocks * tiles)
    if (bsz, v2) == (1, 2048):     # a one-frame request on the H100
        assert rank_major_segments(1, 2048, 132, 2) > 1


@pytest.mark.parametrize("bsz,n,m", [(1, 5120, 2048), (1, 2048, 5120),
                                     (16, 5120, 2048), (16, 2048, 5120),
                                     (3, 2000, 5120), (1, 300, 1000),
                                     (2, 7, 100000)])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_flash_segments_cover_every_key_tile(bsz, n, m, heads):
    tiles = -(-m // FLASH_KEY_TILE)
    q_blocks = -(-n // flash_queries_per_block(heads)) * bsz
    for sms, per_sm in CARDS:
        g = flash_segments(bsz, n, m, heads, sms, per_sm)
        assert 1 <= g <= tiles
        assert _each_tile_once(tiles, g)
        # no segment walks more tiles than the kernel's mask words hold
        assert len(segment_tiles(tiles, g, 0)) <= FLASH_MAX_SEGMENT_TILES
        assert q_blocks * g >= min(2 * sms, q_blocks * tiles)


@pytest.mark.parametrize("bsz,n,m", [(1, 5120, 2048), (1, 2048, 5120),
                                     (8, 5120, 2048), (8, 2048, 5120),
                                     (16, 5120, 2048), (3, 2000, 5002),
                                     (2, 7, 100000)])
def test_flash_backward_segments_cover_every_tile(bsz, n, m):
    """Both kernels of the backward: the dq kernel's key walk and the dkv
    kernel's walk over the queries padded to whole dq blocks."""
    q_blocks = -(-n // FLASH_BWD_ROWS) * bsz
    k_blocks = -(-m // FLASH_BWD_ROWS) * bsz
    k_tiles = -(-m // FLASH_BWD_TILE)
    q_tiles = -(-n // FLASH_BWD_ROWS) * FLASH_BWD_ROWS // FLASH_BWD_TILE
    for sms, per_sm in CARDS:
        gq, gkv = flash_backward_segments(bsz, n, m, sms, per_sm, per_sm)
        for g, tiles, blocks in ((gq, k_tiles, q_blocks),
                                 (gkv, q_tiles, k_blocks)):
            assert 1 <= g <= tiles
            assert _each_tile_once(tiles, g)
            assert len(segment_tiles(tiles, g, 0)) <= FLASH_MAX_SEGMENT_TILES
            # two blocks on every SM, as far as the tiles allow
            assert blocks * g >= min(2 * sms, blocks * tiles)
    if (bsz, n, m) == (8, 2048, 5120):   # the train step's PC -> CAD call
        assert flash_backward_segments(8, 2048, 5120, 132, 3, 3)[0] > 1


@pytest.mark.parametrize("bsz,p", [(1, 10240), (16, 10240), (1, 3110),
                                   (3, 2000), (2, 37), (16, 5)])
def test_consistency_segments_cover_every_row_tile(bsz, p):
    tiles = -(-p // PCM_ROW_TILE)
    col_blocks = -(-p // PCM_COL_TILE) * bsz
    for sms, per_sm in CARDS:
        s = consistency_segments(bsz, p, sms, per_sm)
        assert 1 <= s <= tiles
        assert _each_tile_once(tiles, s)
        assert col_blocks * s >= min(2 * sms, col_blocks * tiles)
    if (bsz, p) == (1, 10240):     # one frame of the PC-major filter
        assert consistency_segments(1, 10240, 132, 2) > 1


def _segment_state(q, k, v, valid, scale, keys):
    """A segment's partial state over the keys `keys`, as the forward
    kernel writes it: per (frame, query, head) the running max m (-inf
    without a valid key), the sum l of exp(s - m) and the unnormalised
    accumulator sum exp(s - m) v, in f32."""
    s = torch.einsum("bndh,bmdh->bnhm", q, k[:, keys]) * scale
    s = s.masked_fill(~valid[:, None, None, keys], -np.inf)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(m == -np.inf, 0.0, m)[..., None])
    acc = torch.einsum("bnhm,bmdh->bndh", p, v[:, keys])
    return m, p.sum(-1), acc


def _merge_segments(states):
    """The combine pass: segments in order against the largest running
    max of each (query, head); an empty segment weighs 0, a row whose
    segments are all empty gets zeros and lse = -inf."""
    big = torch.stack([m for m, _, _ in states]).amax(0)
    total_l = torch.zeros_like(big)
    total_acc = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.where(m == -np.inf, 0.0, torch.exp(m - big))
        total_l = total_l + w * l
        total_acc = total_acc + w[:, :, None, :] * acc
    inv = torch.where(total_l > 0, 1.0 / total_l, 0.0)
    lse = torch.where(total_l > 0, big + torch.log(total_l), -np.inf)
    return total_acc * inv[:, :, None, :], lse


@pytest.mark.parametrize("segments", [1, 3, 7])
def test_split_kv_merge_matches_one_pass_and_float64(segments):
    """The forward kernel's split-KV arithmetic on the CPU: key tiles
    interleaved over segments, each segment's state, the fixed-order
    merge; against the one-pass plain attention and float64. Frame 0 has
    valid keys only in its first two tiles (so with 3 or 7 segments some
    segments have none), frame 1 none at all, frame 2 random ones."""
    rng = np.random.default_rng(14)
    bsz, n, m, scale = 3, 24, 7 * FLASH_KEY_TILE - 5, 0.25
    q, k, v = (torch.as_tensor(rng.normal(size=(bsz, s, 16, 2)).astype(
        np.float32)) for s in (n, m, m))
    valid = torch.as_tensor(rng.random((bsz, m)) > 0.5)
    valid[0] = False
    valid[0, :2 * FLASH_KEY_TILE - 3] = True
    valid[1] = False
    tiles = -(-m // FLASH_KEY_TILE)
    states = []
    for g in range(segments):
        keys = torch.as_tensor([j for t in segment_tiles(tiles, segments, g)
                                for j in range(t * FLASH_KEY_TILE,
                                               min(m, (t + 1) * FLASH_KEY_TILE))],
                               dtype=torch.long)
        states.append(_segment_state(q, k, v, valid, scale, keys))
    if segments == 7:
        assert bool((states[5][0][0] == -np.inf).all())  # an empty segment
    out, lse = _merge_segments(states)
    # against the one-pass plain version: f32 both, other orders
    torch.testing.assert_close(out, flash_cross_attention(q, k, v, valid,
                                                          scale),
                               rtol=0, atol=1e-5)
    # against float64
    s = np.einsum("bndh,bmdh->bnhm", q.double().numpy(), k.double().numpy())
    s = np.where(valid.numpy()[:, None, None], s * scale, -np.inf)
    with np.errstate(invalid="ignore", divide="ignore"):
        top = s.max(-1, keepdims=True)
        p = np.exp(s - top)
        ref_lse = (top[..., 0] + np.log(p.sum(-1)))
        ref = np.einsum("bnhm,bmdh->bndh", p / p.sum(-1, keepdims=True),
                        v.double().numpy())
    ref[1] = 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    has = valid.any(-1).numpy()
    # log-sum-exp: f32 sums of <= 219 terms, relative to 1 + |L|
    np.testing.assert_allclose(lse.numpy()[has], ref_lse[has], rtol=1e-5,
                               atol=1e-5)
    assert bool((lse[1] == -np.inf).all()) and not out[1].any()


def test_attention_plain_matches_float64_softmax():
    rng = np.random.default_rng(5)
    bsz, n, m, dim, h = 2, 40, 33, 16, 2
    q, k, v = (rng.normal(size=(bsz, s, dim, h)).astype(np.float32)
               for s in (n, m, m))
    valid = rng.random((bsz, m)) > 0.4
    valid[1] = False                 # a frame with no valid key at all
    out = flash_cross_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                torch.as_tensor(valid), dim ** -0.5)
    s = np.einsum("bndh,bmdh->bhnm", q.astype(np.float64), k) / dim ** 0.5
    s = np.where(valid[:, None, None], s, -np.inf)
    with np.errstate(invalid="ignore"):    # frame 1: -inf - -inf
        p = np.exp(s - s.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
    ref = np.einsum("bhnm,bmdh->bndh", p, v)
    ref[1] = 0.0                     # rows with no valid key are zeros
    # f32 against f64 on O(1) values: f32 rounding only
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_attention_module_matches_jax_xla_branch():
    """The port's MultiHeadedAttention (f32) against the JAX package's
    XLA branch, which rounds q, k, v and the probabilities to bf16."""
    rng = np.random.default_rng(6)
    n, m, d_model = 64, 48, 32
    x = rng.normal(size=(n, d_model)).astype(np.float32)
    src = rng.normal(size=(m, d_model)).astype(np.float32)
    x_valid = np.arange(n) < 60
    s_valid = np.arange(m) < 40
    mod = JaxMHA(num_heads=2, d_model=d_model)
    params = mod.init(jax.random.PRNGKey(0), x, src, src, x_valid, s_valid)
    ref = np.asarray(mod.apply(params, x, src, src, x_valid, s_valid))
    port = MultiHeadedAttention(2, d_model)
    port.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = port(_t(x), _t(src), _t(src), _t(x_valid), _t(s_valid))[0]
    # bf16 keeps 8 mantissa bits (relative 2^-8 ~ 4e-3) on q, k, v and
    # the probabilities; a few such roundings through the merge layer
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


def test_attention_gradients_match_jax(monkeypatch):
    """jax.grad of the JAX MultiHeadedAttention XLA branch (its bf16
    casts turned into f32, in this test only) against autograd through
    the port's module on the CPU (the plain version), over two frames:
    one with padded queries and keys, one whose keys are all masked."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)
    rng = np.random.default_rng(8)
    n, m, d_model = 64, 48, 32
    x = rng.normal(size=(2, n, d_model)).astype(np.float32)
    src = rng.normal(size=(2, m, d_model)).astype(np.float32)
    ct = rng.normal(size=(2, n, d_model)).astype(np.float32)
    x_valid = np.stack([np.arange(n) < 60, np.arange(n) < 50])
    s_valid = np.stack([np.arange(m) < 40, np.zeros(m, bool)])
    mod = JaxMHA(num_heads=2, d_model=d_model)
    params = mod.init(jax.random.PRNGKey(0), x[0], src[0], src[0],
                      x_valid[0], s_valid[0])

    def jloss(p, xs, ss):
        out = jax.vmap(lambda a, b, av, bv: mod.apply(p, a, b, b, av, bv))(
            xs, ss, x_valid, s_valid)
        return jnp.sum(out * ct)

    gp, gx, gs = jax.grad(jloss, argnums=(0, 1, 2))(params, x, src)
    port = MultiHeadedAttention(2, d_model)
    port.load_state_dict(state_dict_from_flax(params["params"]))
    tx, ts = (torch.tensor(a, requires_grad=True) for a in (x, src))
    out = port(tx, ts, ts, torch.as_tensor(x_valid), torch.as_tensor(s_valid))
    assert out.grad_fn is not None
    (out * torch.as_tensor(ct)).sum().backward()
    grads = flax_from_state_dict({k: p.grad for k, p in
                                  port.named_parameters()})
    pairs = [(tx.grad.numpy(), np.asarray(gx), "x"),
             (ts.grad.numpy(), np.asarray(gs), "source")]
    for layer, leaves in grads.items():
        for leaf, g in leaves.items():
            pairs.append((g, np.asarray(gp["params"][layer][leaf]),
                          f"{layer}/{leaf}"))
    for got, want, name in pairs:
        # f32 on both sides, sums over <= 64 rows of O(1) terms; proj_k's
        # bias gradient is 0 in exact arithmetic (a softmax does not see
        # a shift of all its keys), so the floor is absolute
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-5,
                                   err_msg=name)
    # padded query rows get no gradient; nor does the key-less frame's
    # source (its probabilities are 0 whatever the keys)
    assert not tx.grad[0, 60:].any() and not tx.grad[1, 50:].any()
    assert not ts.grad[0, 40:].any() and not ts.grad[1].any()


def test_attention_backward_plain_is_autograd_of_plain():
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, s, 16, 2)).astype(
        np.float32)) for s in (24, 20, 20))
    valid = torch.as_tensor(rng.random((2, 20)) > 0.3)
    valid[1] = False
    dout = torch.as_tensor(rng.normal(size=(2, 24, 16, 2)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_cross_attention(*leaves, valid, 0.25)
    assert out.grad_fn is not None
    want = torch.autograd.grad(out, leaves, dout)
    before = dict(LAUNCHES)
    got = flash_cross_attention_backward(q, k, v, valid, 0.25, None, None,
                                         dout)
    assert LAUNCHES == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not got[1][1].any() and not got[2][1].any()


def test_cpu_tensors_never_launch():
    before = dict(LAUNCHES)
    a, b, valid = _cdist_inputs(7, 16, 16, 3, 10)
    masked_topk_cdist(_t(a), _t(b), _t(valid), k=5)
    masked_argmin_cdist(_t(a), _t(b), _t(valid))
    assert LAUNCHES == before


def _tf32_split(x):
    """x = hi + lo as the backward kernel splits an f32 operand: hi is x
    truncated to TF32 (its low 13 bits dropped), lo the exact rest as the
    tensor core reads it (its low 13 bits dropped too)."""
    x = np.ascontiguousarray(x, np.float32)
    hi = (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    lo = ((x - hi).view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    return hi, lo


def _mma3(a, b):
    """a @ b as the kernel's 3xTF32 mma.sync chain computes it: per step
    of 8 along k, the products a_lo b_hi, a_hi b_lo and a_hi b_hi (each
    exact in float64) added to an f32 accumulator one mma at a time."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc + x[:, ks].astype(np.float64)
                   @ y[ks].astype(np.float64)).astype(np.float32)
    return acc


def _backward_3xtf32(q, k, v, valid, scale, out, lse, dout):
    """The backward kernel's arithmetic on the CPU (numpy f32, (B, N, 16,
    H) layout): a row with dout all zero or L = -inf takes L = +inf;
    P = exp2(s * scale log2 e - L log2 e) (an f32 FMA, then exp2), 0 on
    masked keys; D = dout . out; dS = P (dP - D); every product 3xTF32;
    masked keys' dk, dv written as zeros."""
    log2e = np.float32(np.log2(np.e))
    sl2e = np.float32(np.float32(scale) * log2e)
    dq, dk, dv = (np.zeros_like(t) for t in (q, k, v))
    for b in range(q.shape[0]):
        live = (dout[b] != 0).any((1, 2))
        kv = valid[b]
        for h in range(q.shape[3]):
            qh, kh, vh, gh, oh = (t[b, :, :, h] for t in (q, k, v, dout, out))
            lh = lse[b, :, h]
            l2 = np.where(live & (lh != -np.inf), (lh * log2e).astype(
                np.float32), np.float32(np.inf))
            d = (gh * oh).sum(-1, dtype=np.float32)
            s = _mma3(qh, kh.T)
            x = (s.astype(np.float64) * sl2e - l2[:, None]).astype(np.float32)
            p = np.where(kv[None], np.exp2(x), np.float32(0)).astype(
                np.float32)
            ds = (p * (_mma3(gh, vh.T) - d[:, None])).astype(np.float32)
            dq[b, :, :, h] = _mma3(ds, kh) * np.float32(scale)
            dk[b, :, :, h] = np.where(kv[:, None], _mma3(ds.T, qh)
                                      * np.float32(scale), 0)
            dv[b, :, :, h] = np.where(kv[:, None], _mma3(p.T, gh), 0)
    return dq, dk, dv


@pytest.mark.parametrize("n,m", [(80, 48), (48, 80)])
def test_backward_3xtf32_emulation_within_chip_tolerance(n, m):
    """The backward kernel's precision, emulated, against float64
    autograd within chip_smoke.py's tolerance for it (1e-4 * max|ref| +
    1e-6 per tensor): frame 0 with padded queries (dout = 0 there) and a
    prefix of valid keys, frame 1 without keys, frame 2 random masks."""
    rng = np.random.default_rng(21)
    bsz, scale = 3, 0.25
    q, k, v = (rng.normal(size=(bsz, s, 16, 2)).astype(np.float32)
               for s in (n, m, m))
    valid = rng.random((bsz, m)) > 0.4
    valid[0] = np.arange(m) < m - 11
    valid[1] = False
    q_valid = rng.random((bsz, n)) > 0.2
    q_valid[0] = np.arange(n) < n - 9
    dout = (rng.normal(size=(bsz, n, 16, 2)) * q_valid[..., None, None]
            ).astype(np.float32)
    tq, tk, tv, tvalid = (torch.as_tensor(x) for x in (q, k, v, valid))
    out = flash_cross_attention_plain(tq, tk, tv, tvalid, scale)
    s32 = torch.einsum("bndh,bmdh->bnhm", tq, tk) * scale
    lse = torch.logsumexp(s32.masked_fill(~tvalid[:, None, None], -np.inf),
                          -1)
    got = _backward_3xtf32(q, k, v, valid, scale, out.numpy(), lse.numpy(),
                           dout)
    want = flash_cross_attention_backward(
        *(torch.as_tensor(x).double() for x in (q, k, v)), tvalid, scale,
        None, None, torch.as_tensor(dout).double())
    for a, b in zip(got, want):
        b = b.numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-6)
    assert not got[0][1].any() and not got[1][~valid].any() \
        and not got[2][~valid].any()
    assert not got[0][~q_valid].any()     # dead rows take L = +inf


@pytest.mark.parametrize("masks", ["prefix", "random"])
def test_backward_skips_are_exact(masks):
    """What the backward kernel skips contributes exactly nothing, as the
    plain backward computes it: query rows with dout = 0 get dq = 0 and
    masked keys dk = dv = 0, bit for bit; and dropping those rows and
    keys leaves the other gradients unchanged to f32 rounding."""
    rng = np.random.default_rng(22)
    bsz, n, m = 2, 72, 40
    q, k, v = (torch.as_tensor(rng.normal(size=(bsz, s, 16, 2)).astype(
        np.float32)) for s in (n, m, m))
    if masks == "prefix":
        live = torch.arange(n) < 50
        valid = torch.arange(m) < 30
    else:
        live = torch.as_tensor(rng.random(n) > 0.3)
        valid = torch.as_tensor(rng.random(m) > 0.3)
    live, valid = live.expand(bsz, n), valid.expand(bsz, m).clone()
    dout = torch.as_tensor(rng.normal(size=(bsz, n, 16, 2)).astype(
        np.float32)) * live[..., None, None]
    dq, dk, dv = flash_cross_attention_backward(q, k, v, valid, 0.25, None,
                                                None, dout)
    assert not dq[~live].any()
    assert not dk[~valid].any() and not dv[~valid].any()
    # the live queries and valid keys alone
    li, vi = live[0], valid[0]
    sq, sk, sv = flash_cross_attention_backward(
        q[:, li], k[:, vi], v[:, vi], valid[:, vi], 0.25, None, None,
        dout[:, li])
    for a, b in ((dq[:, li], sq), (dk[:, vi], sk), (dv[:, vi], sv)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * b.abs().max().item())


@pytest.mark.parametrize("live", [[64, 64], [50, 13]])
def test_masked_consistency_plain_matches_pallas_pc_major(live):
    """PC-major inputs as the filter builds them, on two frames: pair
    index = PC point * 5 + rank, cb in groups of 5 equal points, CAD
    endpoints drawn from 96 points (nearby PC points share candidates,
    so many pairs are a point and itself), live rows a prefix of PC
    points; against the Pallas kernel in interpret mode per frame."""
    rng = np.random.default_rng(23)
    v2, k = 64, 5
    p = v2 * k
    cad = (rng.normal(size=(2, 96, 3)) * 3).astype(np.float32)
    own = np.arange(v2) % 96
    pc = cad[:, own] + rng.normal(size=(2, v2, 3)).astype(np.float32) * 0.1
    pick = rng.integers(0, 96, size=(2, v2, k))
    pick[..., 0] = own
    ca = np.stack([cad[f][pick[f].reshape(-1)] for f in range(2)])
    cb = np.repeat(pc + np.float32(100.0), k, axis=1).astype(np.float32)
    w = np.stack([np.repeat((np.arange(v2) < n).astype(np.float32), k)
                  for n in live])
    before = dict(LAUNCHES)
    out = masked_consistency_sum(*(torch.as_tensor(x) for x in (ca, cb, w)))
    assert LAUNCHES == before
    torch.testing.assert_close(out, masked_consistency_sum_plain(
        *(torch.as_tensor(x) for x in (ca, cb, w))), rtol=0, atol=0)
    for f in range(2):
        ref = jax_mcs(jnp.asarray(ca[f]), jnp.asarray(cb[f]),
                      jnp.asarray(w[f]), block_i=64, block_j=64,
                      interpret=True)
        # both expand |x - y|^2 as x^2 - 2xy + y^2: with the PC side ~100
        # cm out that cancels to ~eps * 1e4 in d^2 (~3e-2 in d for equal
        # points); sums of <= 320 terms of size ~5 in another order
        np.testing.assert_allclose(out[f].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=5e-2)


def _inline_ransac_scores(Rs, ts, src, dst, vmask, thr2):
    """RANSAC's scoring as solvers/ransac.py ran it inline before the
    kernel op: (B, H, N) residual planes, every frame scored."""
    d2 = torch.zeros((*Rs.shape[:2], src.shape[1]), dtype=torch.float32)
    for i in range(3):
        pred_i = (Rs[:, :, i, 0, None] * src[:, None, :, 0]
                  + Rs[:, :, i, 1, None] * src[:, None, :, 1]
                  + Rs[:, :, i, 2, None] * src[:, None, :, 2]
                  + ts[:, :, i, None])
        d2 = d2 + (pred_i - dst[:, None, :, i]) ** 2
    return ((d2 < thr2[:, None, None]) * vmask[:, None]).sum(-1)


def _ransac_hypotheses(seed, bsz, h, n, spread):
    """Frames of n pairs under a known pose (half of them moved far off)
    and h hypotheses near that pose, rotated by ~`spread` rad and shifted
    by ~`spread` x 10 (normal draws): residuals of every size around the
    threshold 0.5, so that many pairs lie within rounding of it."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(bsz, n, 3)) * 10).astype(np.float32)
    Rs, ts, dst = [], [], np.empty_like(src)
    for f in range(bsz):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        q *= np.sign(np.linalg.det(q))
        t = rng.normal(size=3) * 20
        dst[f] = src[f] @ q.T + t + rng.normal(size=(n, 3)) * 0.2
        off = rng.random(n) < 0.5
        dst[f, off] += rng.normal(size=(off.sum(), 3)) * 5
        for _ in range(h):
            w = rng.normal(size=3) * spread
            a = np.linalg.norm(w)
            k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                          [-w[1], w[0], 0]]) / max(a, 1e-12)
            dr = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
            Rs.append(dr @ q)
            ts.append(t + rng.normal(size=3) * spread * 10)
    Rs = np.asarray(Rs, np.float32).reshape(bsz, h, 3, 3)
    ts = np.asarray(ts, np.float32).reshape(bsz, h, 3)
    vmask = (rng.random((bsz, n)) < 0.8).astype(np.float32)
    thr2 = np.full(bsz, 0.25, np.float32)
    return [torch.as_tensor(x) for x in (Rs, ts, src, dst.astype(np.float32),
                                         vmask, thr2)]


@pytest.mark.parametrize("bsz,h,n,live", [
    (3, 64, 300, (True, False, True)),     # H divides neither N nor a tile
    (2, 7, 50, (False, True)),
    (1, 130, 257, (True,)),                # past one block and one tile
    (4, 16, 1, (True, True, False, True))])
def test_ransac_counts_plain_equals_inline_scoring(bsz, h, n, live):
    """The op on CPU tensors (its plain version) gives the inline
    scoring's counts on active frames, bit for bit, and 0 on the rows of
    inactive ones, without a launch."""
    Rs, ts, src, dst, vmask, thr2 = _ransac_hypotheses(bsz, bsz, h, n, 0.02)
    active = torch.tensor(live)
    before = dict(LAUNCHES)
    got = ransac_inlier_counts(Rs, ts, src, dst, vmask, thr2, active)
    assert LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (bsz, h)
    want = _inline_ransac_scores(Rs, ts, src, dst, vmask, thr2)
    assert torch.equal(got[active], want[active])
    assert not got[~active].any()
    assert want[active].max() > 0 and want.min() < n


def test_ransac_counts_match_float64_off_the_threshold():
    """Away from the threshold rounding cannot move a pair: there the
    counts are float64's."""
    Rs, ts, src, dst, vmask, thr2 = _ransac_hypotheses(5, 2, 32, 400, 0.01)
    got = ransac_inlier_counts(Rs, ts, src, dst, vmask, thr2,
                               torch.tensor([True, True]))
    e = (np.einsum("bhij,bnj->bhni", Rs.double().numpy(),
                   src.double().numpy()) + ts.double().numpy()[:, :, None]
         - dst.double().numpy()[:, None])
    d2 = (e * e).sum(-1)
    near = np.abs(d2 - 0.25) < 1e-4
    counts = ((d2 < 0.25) & (vmask.numpy()[:, None] > 0)).sum(-1)
    clear = ~(near & (vmask.numpy()[:, None] > 0)).any(-1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.numpy()[clear], counts[clear])


@pytest.mark.parametrize("bsz,h,n", [(64, 512, 10240), (1, 512, 10240),
                                     (1, 1024, 10240), (16, 1024, 2000),
                                     (2, 7, 50), (3, 256, 300)])
def test_ransac_segments_cover_every_pair_tile(bsz, h, n):
    tiles = -(-n // RANSAC_PAIR_TILE)
    blocks = -(-h // RANSAC_HYP_TILE) * bsz
    for sms, per_sm in CARDS + [(132, 16)]:
        s = ransac_segments(bsz, h, n, sms, per_sm)
        assert 1 <= s <= tiles
        assert _each_tile_once(tiles, s)
        # two blocks on every SM, as far as the pair tiles allow
        assert blocks * s >= min(2 * sms, blocks * tiles)
    if (bsz, h, n) == (1, 512, 10240):    # a one-frame request's block
        assert ransac_segments(1, 512, 10240, 132, 16) == tiles



def _icp_update_case(seed, bsz, n, m, noise=0.05):
    """ICP update inputs as the cloud-to-model ICP sees them: tgt a CAD of
    m points on an ellipsoid shell (semi-axes 7, 5, 3: every rotation
    determined), src n of them posed about 50 out plus noise, the last
    tenth of each frame's rows padding (invalid); the match (j, dmin)
    from the exact nearest neighbour under a pose a few degrees off, the
    gate (0.2 x 14)^2. Returns the op's arguments as tensors."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(bsz, m, 3))
    tgt = (u / np.linalg.norm(u, axis=-1, keepdims=True)
           * [7.0, 5.0, 3.0]).astype(np.float32)
    src = np.empty((bsz, n, 3), np.float32)
    R = np.empty((bsz, 3, 3), np.float32)
    t = np.empty((bsz, 3), np.float32)
    for f in range(bsz):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        q *= np.sign(np.linalg.det(q))
        tg = np.array([0.0, 0.0, 50.0]) + rng.normal(size=3)
        src[f] = (tgt[f, rng.integers(0, m, n)] @ q.T + tg
                  + noise * rng.normal(size=(n, 3)))
        w = rng.normal(size=3) * 0.05
        a = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]]) / a
        dr = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
        R[f] = dr @ q.T
        t[f] = -R[f] @ tg + rng.normal(size=3) * 0.3
    valid = np.arange(n)[None].repeat(bsz, 0) < n - n // 10
    moved = np.einsum("bij,bnj->bni", R.astype(np.float64), src) + t[:, None]
    d2 = ((moved[:, :, None] - tgt[:, None].astype(np.float64)) ** 2).sum(-1)
    j = d2.argmin(-1).astype(np.int32)
    dmin = d2.min(-1).astype(np.float32)
    gate = np.full(bsz, (0.2 * 14.0) ** 2, np.float32)
    return [torch.as_tensor(x) for x in (src, valid, tgt, j, dmin, gate, R,
                                         t)]


def _horn_f64(src, valid, tgt, j, dmin, gate):
    """(R, t) of the gated weighted fit in float64: centred H, Horn's
    matrix, numpy's eigh."""
    s, d = src.double().numpy(), tgt.double().numpy()
    Rs, ts = [], []
    for f in range(s.shape[0]):
        w = (valid[f] & (dmin[f] < gate[f])).numpy()
        a, b = s[f][w], d[f][j[f].numpy()[w]]
        mu_a, mu_b = a.mean(0), b.mean(0)
        H = (a - mu_a).T @ (b - mu_b) / len(a)
        (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = H
        N = np.array([
            [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
            [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
            [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
            [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]])
        qw, qx, qy, qz = np.linalg.eigh(N)[1][:, -1]
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]])
        Rs.append(R)
        ts.append(mu_b - R @ mu_a)
    return np.stack(Rs), np.stack(ts)


@pytest.mark.parametrize("bsz,n,m", [(3, 400, 256), (2, 1000, 1280),
                                     (1, 64, 5120)])
def test_icp_update_plain_matches_jax_jacobi_and_float64_horn(bsz, n, m):
    """The op on CPU tensors (its plain version, no launch) against the
    JAX package's Kabsch (Horn by its unrolled Jacobi) fed the same
    gated pairs, and against float64 Horn. Tolerances: float32 sums of
    points ~50 out (the means carry ~50 x 2^-24 each) and a Jacobi
    converged to float32: R's entries within 2e-6, t within 5e-5 of the
    JAX package's; 2e-6 and 5e-5 of float64's."""
    args = _icp_update_case(bsz * 7 + n, bsz, n, m)
    src, valid, tgt, j, dmin, gate, R, t = args
    before = dict(LAUNCHES)
    R2, t2, applied = icp_kabsch_update(*args)
    assert LAUNCHES == before
    assert R2.dtype == t2.dtype == torch.float32
    assert applied.dtype == torch.uint8 and applied.tolist() == [1] * bsz
    w = (valid & (dmin < gate[:, None])).float()
    assert 0.5 < float(w.sum()) / w.numel() < 1.0
    d = torch.gather(tgt, 1, j.long()[..., None].expand(-1, -1, 3))
    jR, jt = jax.vmap(jax_kabsch.kabsch_umeyama)(
        jnp.asarray(src.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(w.numpy()))
    np.testing.assert_allclose(R2.numpy(), np.asarray(jR), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt), rtol=0, atol=5e-5)
    R64, t64 = _horn_f64(*args[:6])
    np.testing.assert_allclose(R2.numpy(), R64, rtol=0, atol=2e-6)
    np.testing.assert_allclose(t2.numpy(), t64, rtol=0, atol=5e-5)


def test_icp_update_degenerate_frames():
    """Frame 0 keeps two gated pairs and frame 1 has no valid point: both
    keep R and t bit for bit, applied 0. Frame 2's padded rows (invalid)
    change nothing whatever they hold: far coordinates, the last index
    and a zero distance give the bits of zeros, index 0 and 1e9."""
    src, valid, tgt, j, dmin, gate, R, t = _icp_update_case(11, 3, 300, 200)
    valid[0] = False
    valid[0, :2] = True
    dmin[0, :2] = 0.0
    valid[1] = False
    pad = ~valid[2]
    src[2, pad] = 1e6
    j[2, pad] = 199
    dmin[2, pad] = 0.0
    R2, t2, applied = icp_kabsch_update(src, valid, tgt, j, dmin, gate, R, t)
    assert applied.tolist() == [0, 0, 1]
    assert torch.equal(R2[:2], R[:2]) and torch.equal(t2[:2], t[:2])
    src[2, pad], j[2, pad], dmin[2, pad] = 0.0, 0, 1e9
    plain = icp_kabsch_update(src, valid, tgt, j, dmin, gate, R, t)
    assert torch.equal(plain[0], R2) and torch.equal(plain[1], t2)


def test_icp_update_rotation_on_exactly_symmetric_h():
    """An exactly symmetric H zeroes the first row of Horn's matrix off
    the diagonal: every pivot with p = 0 takes the |apq| < 1e-30 guard.
    diag(3, 2, 1) (+ symmetric off-diagonals) gives R = I exactly;
    diag(1, 1, -5) ties the two largest eigenvalues, and the first
    column wins (R = diag(1, -1, -1)), as jnp.argmax picks it in the JAX
    package: both bit for bit the JAX package's."""
    hs = np.array([[[3.0, 0.5, -0.25], [0.5, 2.0, 0.125], [-0.25, 0.125, 1.0]],
                   [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -5.0]]],
                  np.float32)
    got = rotation_from_h_jacobi(torch.as_tensor(hs)).numpy()
    want = np.asarray(jax.vmap(jax_kabsch._rotation_from_H_quat)(
        jnp.asarray(hs)))
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got[1], np.diag([1.0, -1.0, -1.0])
                                  .astype(np.float32))
    np.testing.assert_array_equal(got, want)
