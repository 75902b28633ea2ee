"""Every kernel shape that the JAX package's entry points reach, on the
CPU against the JAX package on the same numpy inputs, and the kernel
wrappers' shape logic that the card runs:

- the attention module at head dims 8, 64 and 128 and at 3 and 8 heads
  against JAX's XLA branch (its bf16 casts patched to f32), forward and
  gradients;
- a small DPFMNet at gnn_dim 128 / num_head 2 (head dim 64) against JAX
  through the weight converter;
- the port's `cli.resolve --topk 24` against the JAX command on the same
  result file;
- the wrappers' layout: a head dim padded to its instance dim, the
  heads folded into frames for every head count, each held against the
  unpadded, unfolded plain version (the kernel launch replaced by the
  plain version on the laid-out tensors); the pre-scale rule; the top-k
  wide path's plan (an emulation of its radix select against the plain
  top-k); the segment plans at the new instances.

On the CPU the port runs the plain versions; the card's kernels are held
against them by chip_smoke.py."""
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose6d_tpu.cli.resolve as jax_resolve
import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.models import DPFMConfig as JaxConfig
from pose6d_tpu.models import DPFMNet as JaxNet
from pose6d_tpu.models.attention import MultiHeadedAttention as JaxMHA
from pose6d_tpu_torch.cli import resolve
from pose6d_tpu_torch.models import DPFMConfig, DPFMNet
from pose6d_tpu_torch.models.attention import MultiHeadedAttention
from pose6d_tpu_torch.models.weights import (flax_from_state_dict,
                                             state_dict_from_flax)
from pose6d_tpu_torch.ops.kernels import (LAUNCHES, masked_topk_cdist_plain)
from pose6d_tpu_torch.ops.kernels import attention as kattn
from pose6d_tpu_torch.ops.kernels import cdist as kcdist
from pose6d_tpu_torch.ops.kernels._build import segment_tiles

from test_torch_filter_pcmajor import _filter_inputs

torch.set_num_threads(2)

# (heads, d_model): head dims 8, 64, 128; 3 heads of 16, 8 heads of 8
WIDE_ATTENTION = [(2, 16), (2, 128), (2, 256), (3, 48), (8, 64)]


@pytest.fixture
def f32_refiner(monkeypatch):
    """JAX's XLA attention with its bf16 casts turned into f32, in the
    asking test only."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)


@pytest.mark.parametrize("heads,d_model", WIDE_ATTENTION)
def test_attention_module_matches_jax_at_any_head_shape(heads, d_model,
                                                        f32_refiner):
    """Two frames (padded queries and keys; the second without keys):
    the output and every gradient (x, source, each weight) of autograd
    through the port's module against jax.grad of JAX's, both in f32.
    Sums over <= 48 keys or 64 rows of O(1) terms: 1e-5 of each
    tensor's largest entry, plus 1e-5 absolute (proj_k's bias gradient
    is 0 in exact arithmetic)."""
    rng = np.random.default_rng(heads * 1000 + d_model)
    n, m = 64, 48
    x = rng.normal(size=(2, n, d_model)).astype(np.float32)
    src = rng.normal(size=(2, m, d_model)).astype(np.float32)
    ct = rng.normal(size=(2, n, d_model)).astype(np.float32)
    x_valid = np.stack([np.arange(n) < 60, np.arange(n) < 50])
    s_valid = np.stack([np.arange(m) < 40, np.zeros(m, bool)])
    mod = JaxMHA(num_heads=heads, d_model=d_model)
    params = mod.init(jax.random.PRNGKey(0), x[0], src[0], src[0],
                      x_valid[0], s_valid[0])

    def japply(p, xs, ss):
        return jax.vmap(lambda a, b, av, bv: mod.apply(p, a, b, b, av, bv))(
            xs, ss, x_valid, s_valid)

    ref = np.asarray(japply(params, x, src))
    gp, gx, gs = jax.grad(lambda p, xs, ss: jnp.sum(japply(p, xs, ss) * ct),
                          argnums=(0, 1, 2))(params, x, src)
    port = MultiHeadedAttention(heads, d_model)
    port.load_state_dict(state_dict_from_flax(params["params"]))
    assert port.dim == d_model // heads
    tx, ts = (torch.tensor(a, requires_grad=True) for a in (x, src))
    before = dict(LAUNCHES)
    out = port(tx, ts, ts, torch.as_tensor(x_valid), torch.as_tensor(s_valid))
    (out * torch.as_tensor(ct)).sum().backward()
    assert LAUNCHES == before             # CPU tensors take the plain version
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max() + 1e-6)
    grads = flax_from_state_dict({k: p.grad for k, p in
                                  port.named_parameters()})
    pairs = [(tx.grad.numpy(), np.asarray(gx), "x"),
             (ts.grad.numpy(), np.asarray(gs), "source")]
    for layer, leaves in grads.items():
        for leaf, g in leaves.items():
            pairs.append((g, np.asarray(gp["params"][layer][leaf]),
                          f"{layer}/{leaf}"))
    for got, want, name in pairs:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-5,
                                   err_msg=name)
    assert not ts.grad[1].any()           # the key-less frame


def _shape(rng, v, n, k_eig=64):
    m = np.arange(v) < n
    evecs = np.linalg.qr(rng.normal(size=(v, k_eig)))[0].astype(np.float32)
    return {"xyz": ((rng.normal(size=(v, 3)) * 5 + 110) * m[:, None]
                    ).astype(np.float32),
            "mass": ((rng.random(v) + 0.5) * m).astype(np.float32),
            "evals": np.sort(rng.random(k_eig) * 50).astype(np.float32),
            "evecs": evecs * m[:, None], "valid": m}


def test_dpfm_head_dim_64_matches_jax(f32_refiner):
    """DPFMNet with gnn_dim 128 and 2 heads (the refiner at head dim 64),
    JAX's init carried into the port strictly: features and overlaps
    within 1e-5 of their largest entry, C within 1e-3 (the regularized
    30 x 30 solve amplifies the summation order), as the config
    variants' forward test holds them."""
    kw = dict(gnn_dim=128, num_heads=2)
    rng = np.random.default_rng(3)
    cad, pc = _shape(rng, 256, 250), _shape(rng, 128, 120)
    jm = JaxNet(JaxConfig(**kw))
    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), as_j(cad),
                                    as_j(pc)))
    ref = {k: np.asarray(v) for k, v in
           jm.apply(params, as_j(cad), as_j(pc)).items()}
    cfg = DPFMConfig.from_yaml_dict({
        "fmap": {"n_fmap": 30, "k_eig": 64, "n_feat": 32, "C_in": 3,
                 "lambda_": 100, "resolvant_gamma": 0.5, "robust": True},
        "attention": {"num_head": 2, "gnn_dim": 128, "ref_n_layers": 1,
                      "cross_sampling_ratio": 1.0,
                      "attention_type": "normal"},
        "overlap": {"overlap_feat_dim": 32}})
    assert (cfg.gnn_dim, cfg.num_heads) == (128, 2)
    model = DPFMNet(cfg)
    model.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    assert model.feat_refiner.layer_0.attn.dim == 64
    with torch.no_grad():
        out = model(*({k: torch.as_tensor(v)[None] for k, v in d.items()}
                      for d in (cad, pc)))
    assert sorted(out) == sorted(ref)
    for key, r in ref.items():
        frac = 1e-3 if key == "C" else 1e-5
        np.testing.assert_allclose(out[key][0].numpy(), r, rtol=0,
                                   atol=frac * np.abs(r).max(), err_msg=key)


def _result_file(path):
    """A result file of the eval layout from the well-separated geometry
    of the filter tests (256 CAD points, 128 PC points, a 30 x 30 map
    near the identity); align_pc is the PC in the CAD's frame (the CAD
    points it was drawn from, found by replaying _filter_inputs' draws)."""
    (C, ex, ey, cad, pc, _, _), diam = _filter_inputs()
    rng = np.random.default_rng(11)               # _filter_inputs' seed
    rng.normal(size=cad.shape)
    perm = rng.permutation(len(cad))[:len(pc)]
    np.savez(path, C_pred=C, evecs_cad=ex, evecs_pc=ey, cad_xyz=cad,
             pcd_depth=pc, align_pc=cad[perm], diam_cad=np.float32(diam),
             p_pred=np.zeros((0, 2), np.int32), ir=np.float32(0.0))


def test_resolve_topk_24_matches_jax(monkeypatch, tmp_path):
    """cli.resolve --topk 24 (the spatial filter over 24 ranks, above the
    card's list instances) with the filter tests' schedule on the CPU
    against the JAX command on copies of one result file: p_pred and ir
    exactly JAX's, every other array untouched."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    _result_file(port_dir / "result_000000.npz")
    shutil.copytree(port_dir, jax_dir)
    flags = ["--topk", "24", "--taus", "0.4", "0.25", "0.12", "0.07",
             "0.09"]
    irs = resolve.main([str(port_dir), "--device", "cpu", *flags])
    monkeypatch.setattr(sys, "argv", ["prog", str(jax_dir), *flags])
    jax_resolve.main()
    a = dict(np.load(port_dir / "result_000000.npz"))
    b = dict(np.load(jax_dir / "result_000000.npz"))
    assert len(irs) == 1 and sorted(a) == sorted(b)
    assert 0 < len(a["p_pred"]) < 24 * 128
    np.testing.assert_array_equal(a["p_pred"], b["p_pred"])
    assert float(a["ir"]) == float(b["ir"]) > 0
    for k in a:
        if k not in ("p_pred", "ir"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the wrappers' shape logic -----------------------------------------------

def test_instance_dims_and_refusal():
    """A head dim d runs at the smallest instance dim >= d; above 128 a
    ValueError names the ROADMAP item (JAX's kernel cannot take it
    either)."""
    assert [kattn.instance_dim(d) for d in
            (1, 8, 15, 16, 17, 32, 33, 48, 64, 65, 100, 128)] == \
        [16, 16, 16, 16, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="ROADMAP.md, section 2, row 1"):
        kattn.instance_dim(129)
    q = torch.zeros(1, 4, 129, 1)
    with pytest.raises(ValueError, match="section 2, row 1"):
        kattn._forward_kernel(q, q, q, torch.ones(1, 4, dtype=torch.bool),
                              129 ** -0.5, False)
    # the planned launch of a 3-head and a dim-64 call: folded frames
    assert kattn.kernel_instance(2, 16, 3) == (6, 1)
    assert kattn.kernel_instance(2, 64, 2) == (4, 1)
    assert kattn.kernel_instance(2, 8, 2) == (2, 2)     # padded to 16 x 2
    assert kattn.kernel_instance(2, 8, 8) == (16, 1)
    assert kattn.kernel_instance(2, 128, 1) == (2, 1)


@pytest.mark.parametrize("dim,heads", [(1, 1), (8, 2), (8, 8), (16, 3),
                                       (24, 2), (48, 1), (64, 2), (100, 3),
                                       (128, 2), (16, 2), (32, 4)])
def test_layout_is_the_same_attention(dim, heads, monkeypatch):
    """The wrappers' layout (the head dim zero-padded to its instance,
    wide tokens folded into one-head frames) around a stand-in launch
    that runs the plain version on the laid-out tensors: forward, lse
    and backward, unpadded and unfolded, equal the plain version of the
    call within f32 summation order (zero channels add exact zeros), and
    the launch sees an instance the kernels have. The caller's scale
    reaches the launch unchanged."""
    rng = np.random.default_rng(dim * 10 + heads)
    bsz, n, m = 2, 20, 33
    q, k, v, dout = (torch.as_tensor(rng.normal(size=(bsz, s, dim, heads)),
                                     dtype=torch.float32)
                     for s in (n, m, m, n))
    kv = torch.as_tensor(rng.random((bsz, m)) > 0.3)
    kv[1] = False                                 # a key-less frame
    sc = dim ** -0.5
    seen = []

    def fwd(q_, k_, v_, kv_, scale, with_lse, segments, instance):
        seen.append((q_.shape[2], q_.shape[3], q_.shape[0], scale, instance))
        return (kattn.flash_cross_attention_plain(q_, k_, v_, kv_, scale)
                .contiguous(),
                kattn.flash_cross_attention_lse_plain(q_, k_, kv_, scale))

    def bwd(q_, k_, v_, kv_, scale, out, lse, dout_, segments, instance):
        seen.append((q_.shape[2], q_.shape[3], q_.shape[0], scale, instance))
        return tuple(t.contiguous() for t in
                     kattn.flash_cross_attention_backward_plain(
                         q_, k_, v_, kv_, scale, dout_))

    monkeypatch.setattr(kattn, "_forward_launch", fwd)
    monkeypatch.setattr(kattn, "_backward_launch", bwd)
    out, lse = kattn._forward_kernel(q, k, v, kv, sc, True)
    grads = kattn._backward_kernel(q, k, v, kv, sc, out, lse, dout)
    frames, kheads = kattn.kernel_instance(bsz, dim, heads)
    want_inst = (kattn.instance_dim(dim), kheads, frames, sc, (dim, heads))
    assert seen == [want_inst, want_inst]
    assert (want_inst[0] in kattn.FLASH_DIMS
            and (kheads == 1 or want_inst[0] * kheads <= 32))
    ref = kattn.flash_cross_attention_plain(q, k, v, kv, sc)
    lref = kattn.flash_cross_attention_lse_plain(q, k, kv, sc)
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, lref, rtol=0, atol=1e-5)
    want = kattn.flash_cross_attention_backward_plain(q, k, v, kv, sc, dout)
    for a, b in zip(grads, want):
        assert a.shape == b.shape and a.is_contiguous()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert not out[1].any() and not grads[0][1].any()


def test_prescale_rule_is_keyed_on_the_scale():
    """q is scaled at load only for a power-of-two scale (1/sqrt of a
    power of 4), never because of the instance's dim: a dim-8 call
    padded to the dim-16 instance keeps 1/sqrt(8). For a power of two
    the pre-scaled products are bit for bit (q . k) * scale; for
    1/sqrt(8) they are not, which is why the rule exists."""
    assert [kattn.prescaled(d ** -0.5) for d in (1, 4, 16, 64, 256)] == \
        [True] * 5
    assert [kattn.prescaled(d ** -0.5) for d in (2, 8, 32, 48, 128)] == \
        [False] * 5
    rng = np.random.default_rng(0)
    q, k = (torch.as_tensor(rng.normal(size=(4096, 8)), dtype=torch.float32)
            for _ in range(2))

    def chain(a, b):                  # an f32 FMA-free chain over d in order
        s = torch.zeros(a.shape[0])
        for d in range(a.shape[1]):
            s = s + a[:, d] * b[:, d]
        return s

    for sc, exact in ((0.25, True), (0.125, True), (8 ** -0.5, False)):
        s32 = torch.tensor(sc, dtype=torch.float32)
        assert torch.equal(chain(q * s32, k), chain(q, k) * s32) == exact


def _radix_topk(d2, k, rows=True):
    """The wide kernel's select in numpy: keys (d2 bits, column) with d2
    >= 0 (a masked column +inf); 4-bit radix passes over the bits fix the
    k-th smallest d2, then the columns below it and the lowest columns
    at it, ranked by (bits, column); +inf comes out as 1e9. For k <= 64
    the select runs over candidates: the columns at or below the largest
    of the 32 lanes' ceil(k / 32)-th smallest bits (lane l takes the
    columns l, l + 32, ...), at most 1024 of them, with passes that start
    below the bits the row's least and largest finite d2 share; fewer
    than k finite columns take every finite column and the first masked
    ones. Else the whole row: `rows`, the route that keeps the row's d2 in
    shared memory, starts below the shared bits too; the recomputing
    walk's passes run over bits 30 .. 0, +inf included."""
    bits = d2.astype(np.float32).view(np.uint32) & np.uint32(0x7fffffff)
    inf = np.uint32(0x7f800000)
    finite = bits[bits < inf]
    keys, cols_of = bits, np.arange(len(bits))
    if k <= len(finite) and k <= 64:
        j = -(-k // 32)
        lanes = [np.sort(bits[lane::32]) for lane in range(32)]
        bound = max(int(v[j - 1]) if len(v) >= j else 0xffffffff
                    for v in lanes)
        cand = np.flatnonzero(bits <= np.uint32(min(bound, 0xffffffff)))
        if len(cand) <= 1024:
            keys, cols_of, rows = bits[cand], cand, True
    top, prefix, fixed, need = 30, 0, 0x80000000, k
    if k > len(finite):
        top, prefix, need = -1, int(inf), k - len(finite)
    elif rows:
        lo, hi = int(bits.min()), int(finite.max())
        if lo == hi:
            top, prefix = -1, lo
        else:
            top = (lo ^ hi).bit_length() - 1
            fixed = ~((2 << top) - 1) & 0xffffffff
            prefix = lo & fixed
    while top >= 0:
        width = min(4, top + 1)
        shift, mask = top + 1 - width, (1 << width) - 1
        match = (keys & np.uint32(fixed)) == np.uint32(prefix)
        hist = np.bincount((keys[match] >> shift) & mask, minlength=16)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, need))      # first bin with cum >= need
        need -= int(cum[b - 1]) if b else 0
        prefix |= b << shift
        fixed |= mask << shift
        top = shift - 1
    prefix = np.uint32(prefix)
    sel = np.concatenate([np.flatnonzero(keys < prefix),
                          np.flatnonzero(keys == prefix)[:need]])
    cols = cols_of[sel]
    assert len(cols) == k
    order = np.lexsort((cols, bits[cols]))
    out = bits[cols][order].view(np.float32).copy()
    out[np.isinf(out)] = 1e9
    return out, cols[order].astype(np.int32)


@pytest.mark.parametrize("k", [12, 17, 24, 32, 64])
@pytest.mark.parametrize("n_valid", [200, 20, 0])
def test_wide_topk_plan_matches_plain(k, n_valid):
    """Above the longest list instance (above 8 past 64 features) the
    wrapper names the wide path (topk_instance(k, c) == k) and hands the
    kernel a (B, N, k) scratch; its select on both routes (over the
    candidates below the lanes' bound, or the whole row), emulated here
    on the kernel's d2, gives the plain top-k (lax.top_k's order and
    fill) exactly: exact ties across columns, rows with fewer valid
    columns than k, and a row without any."""
    assert kcdist.topk_instance(k, 96) == k
    assert kcdist.topk_instance(k) == (16 if k <= 16 else k)
    rng = np.random.default_rng(k + n_valid)
    step = 2.0 ** -10                  # exact-grid: every d2 exact in f32
    a = np.round(rng.normal(size=(16, 30)) * 0.05 / step) * step
    b = np.round(rng.normal(size=(256, 30)) * 0.05 / step) * step
    b[1:64:2] = b[0:64:2]              # exact ties
    valid = np.zeros(256, bool)
    valid[rng.permutation(256)[:n_valid]] = True
    args = [torch.as_tensor(x, dtype=torch.float32)[None] for x in (a, b)]
    pd, pi = masked_topk_cdist_plain(*args, torch.as_tensor(valid)[None], k)
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)
    d2[:, ~valid] = np.inf
    for r in range(len(a)):
        for rows in (True, False):
            od, oi = _radix_topk(d2[r], k, rows)
            np.testing.assert_array_equal(oi, pi[0, r].numpy())
            np.testing.assert_array_equal(od, pd[0, r].numpy())


def test_wide_topk_refuses_more_than_m_columns():
    """lax.top_k takes k <= M; so do the plain version and the wrapper's
    wide path."""
    a, b = torch.zeros(1, 4, 3), torch.zeros(1, 20, 3)
    bv = torch.ones(1, 20, dtype=torch.bool)
    with pytest.raises(ValueError, match="k=24 > 20"):
        masked_topk_cdist_plain(a, b, bv, 24)


CARDS = ((132, 2), (132, 3), (7, 1))


@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("bsz,n,m", [(1, 5120, 2048), (16, 2048, 5120),
                                     (8, 5120, 2048), (3, 2000, 5002),
                                     (2, 7, 100000)])
def test_segment_plans_at_the_wide_instances(dim, bsz, n, m):
    """The forward at DIM 64 and 128 (the tensor-core kernel: 4 warps of
    16 queries a block) and the backward's wide kernels at 64 and 128
    rows a block (4 and 8 warps of 16 rows at the full dim; the queries
    padded to whole dq blocks): every key or query tile in one segment,
    none past the mask words' reach, two blocks on every SM as far as the
    tiles allow."""
    assert kattn.flash_queries_per_block(1, dim) == {64: 64, 128: 64}[dim]
    rows = kattn.flash_backward_rows(dim, 1)
    assert rows == {64: 64, 128: 128}[dim]
    for sms, per_sm in CARDS:
        tiles = -(-m // kattn.FLASH_KEY_TILE)
        g = kattn.flash_segments(bsz, n, m, 1, sms, per_sm, dim)
        blocks = -(-n // kattn.flash_queries_per_block(1, dim)) * bsz
        assert 1 <= g <= tiles
        assert sorted(t for s in range(g) for t in segment_tiles(tiles, g, s)
                      ) == list(range(tiles))
        assert len(segment_tiles(tiles, g, 0)) <= kattn.FLASH_MAX_SEGMENT_TILES
        assert blocks * g >= min(2 * sms, blocks * tiles)
        gq, gkv = kattn.flash_backward_segments(bsz, n, m, sms, per_sm,
                                                per_sm, rows)
        n_pad = kattn.flash_backward_npad(n, rows)
        assert n_pad % rows == 0 and n_pad % kattn.FLASH_BWD_TILE == 0
        assert n <= n_pad < n + rows
        for gg, walked, owned in ((gq, m, n), (gkv, n_pad, m)):
            t = -(-walked // kattn.FLASH_BWD_TILE)
            blk = -(-owned // rows) * bsz
            assert 1 <= gg <= t
            assert len(segment_tiles(t, gg, 0)) <= \
                kattn.FLASH_MAX_SEGMENT_TILES
            assert blk * gg >= min(2 * sms, blk * t)


def test_the_refusals_left_name_their_roadmap_items():
    """The only shape the kernels refuse: head dims above 128 (section 2,
    row 1), which the JAX kernel cannot take either; the refusal comes
    before any launch. The consistency kernels take any endpoint width."""
    with pytest.raises(ValueError, match="ROADMAP.md, section 2, row 1"):
        kattn.kernel_instance(1, 200, 1)
    with pytest.raises(ValueError, match="ROADMAP.md, section 2, row 1"):
        kattn.instance_dim(129)
