"""The port's traceable loops and its kernel ops under torch.export, on the
CPU: LOBPCG, RANSAC's adaptive block loop and exact and grouped FPS, each
exported alone, replay their eager run bit for bit through a while_loop
node; each kernel op passes torch.library.opcheck (schema, fake and
real implementations, autograd registration, AOT dispatch); a Predictor
with rotation TTA and ZoomOut candidates exports and matches its live
run."""
import io

import numpy as np
import pytest
import torch

from pose6d_tpu_torch.ops import sampling
from pose6d_tpu_torch.ops.kernels import attention as kattn
from pose6d_tpu_torch.solvers.icp import icp_point2point
from pose6d_tpu_torch.solvers.ransac import ransac_pose
from pose6d_tpu_torch.spectral.lobpcg import lobpcg_standard

torch.set_num_threads(2)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, *args):
    """fn exported on args, saved and loaded; returns the loaded program."""
    with torch.no_grad():
        program = torch.export.export(_Fn(fn), args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return torch.export.load(io.BytesIO(buf.getvalue()))


def _while_loops(program) -> int:
    return sum(1 for n in program.graph_module.graph.nodes
               if n.op == "call_function" and "while_loop" in str(n.target))


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_lobpcg_exported_equals_eager():
    rng = np.random.default_rng(6)
    n, k = 200, 10
    q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    spec = np.concatenate([np.linspace(10, 5, 20), rng.uniform(0, 4, n - 20)])
    a = torch.as_tensor(((q * spec) @ q.T).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32))

    def fn(a, x):
        return lobpcg_standard(a, x, m=40)

    program = _export(fn, a, x)
    assert _while_loops(program) == 1
    want = fn(a, x)
    got = program.module()(a, x)
    assert 1 < int(want[2]) < 40       # the stop rule ended the loop
    _assert_bit_equal(got, want)


def _op_nodes(program, op):
    """{submodule name: call_function nodes of `op`}, over the program's
    graph modules (a while_loop's body is a submodule)."""
    return {name: sum(1 for n in m.graph.nodes if n.target == op)
            for name, m in program.graph_module.named_modules()
            if isinstance(m, torch.fx.GraphModule)}


def _ransac_case():
    """Two frames of 300 correspondences under known poses, 90 % and 25 %
    inliers: the first meets the trial bound after one block, the second
    after several, both before the last of 16."""
    rng = np.random.default_rng(3)
    src = rng.normal(size=(2, 300, 3)) * 10.0
    dst = np.empty_like(src)
    for b, share in enumerate((0.9, 0.25)):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        dst[b] = src[b] @ R.T + rng.normal(size=3) * 5
        out = rng.random(300) > share
        dst[b, out] = rng.normal(size=(out.sum(), 3)) * 10.0
    valid = np.ones((2, 300), bool)
    valid[1, 280:] = False
    u = rng.random((2, 16, 256, 3))
    t = torch.as_tensor
    return (t(src.astype(np.float32)), t(dst.astype(np.float32)), t(valid),
            t(np.float32([0.5, 0.5])), t(u.astype(np.float32)))


def test_ransac_exported_equals_eager_and_exits_early():
    args = _ransac_case()

    def fn(src, dst, valid, thr, u):
        out = ransac_pose(src, dst, valid, thr, n_hypotheses=4096,
                          hyp_block=256, uniforms=u)
        return out["R"], out["t"], out["n_inliers"], out["n_trials"]

    program = _export(fn, *args)
    assert _while_loops(program) == 1
    # the scoring is one op node, inside the loop's step
    nodes = _op_nodes(program,
                      torch.ops.pose6d_tpu_torch.ransac_inlier_counts.default)
    assert sum(nodes.values()) == 1 and nodes[""] == 0, nodes
    want = fn(*args)
    got = program.module()(*args)
    _assert_bit_equal(got, want)
    trials = want[3].tolist()
    assert trials[0] < trials[1] < 4096        # each frame's own exit
    assert trials[0] % 256 == 0 and trials[1] % 256 == 0


def test_icp_exported_equals_eager_with_one_update_node():
    """ICP (6 iterations at full resolution) exported alone: one
    while_loop whose body holds the update as one icp_kabsch_update node
    and no eigensolve; the program replays the eager run bit for bit."""
    rng = np.random.default_rng(8)
    cad = (rng.normal(size=(2, 300, 3)) * [4.0, 3.0, 2.0]).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    q *= np.sign(np.linalg.det(q))
    pc = (cad[:, :200] @ q.T + [0.0, 0.0, 50.0]
          + 0.01 * rng.normal(size=(2, 200, 3))).astype(np.float32)
    t = torch.as_tensor
    args = (t(pc), t(np.arange(200) < 180).expand(2, -1).contiguous(),
            t(cad), t(np.ones((2, 300), bool)),
            t(np.stack([q.T, q.T]).astype(np.float32)),
            t(np.float32([[0.2, -0.1, -50.0]] * 2)) @ t(q.astype(np.float32)))

    def fn(src, sv, tgt, tv, R, tt):
        out = icp_point2point(src, sv, tgt, tv, R, tt, max_corr_dist=2.0,
                              max_iter=6)
        return out["R"], out["t"], out["rmse"], out["n_corr"]

    program = _export(fn, *args)
    assert _while_loops(program) == 1
    nodes = _op_nodes(program,
                      torch.ops.pose6d_tpu_torch.icp_kabsch_update.default)
    assert sum(nodes.values()) == 1 and nodes[""] == 0, nodes
    targets = [str(n.target) for _, m in program.graph_module.named_modules()
               if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes if n.op == "call_function"]
    assert not [x for x in targets if "eigh" in x], targets
    want = fn(*args)
    _assert_bit_equal(program.module()(*args), want)
    assert (want[3] > 150).all()


def _cloud(seed, n=512, n_valid=430):
    rng = np.random.default_rng(seed)
    pts = np.zeros((2, n, 3), np.float32)
    pts[:, :n_valid] = rng.normal(size=(2, n_valid, 3)) * [30, 20, 5] + \
        [0, 0, 100]
    valid = np.zeros((2, n), bool)
    valid[0, :n_valid] = True
    valid[1, :n_valid // 2] = True
    return torch.as_tensor(pts), torch.as_tensor(valid)


@pytest.mark.parametrize("groups", [1, 8])
def test_fps_exported_equals_eager(groups):
    pts, valid = _cloud(4)

    def fn(pts, valid):
        if groups == 1:
            return sampling.farthest_point_sample(pts, valid, 240)
        return sampling.farthest_point_sample_grouped(pts, valid, 240,
                                                      groups=groups)

    program = _export(fn, pts, valid)
    assert _while_loops(program) == 1
    want = fn(pts, valid)
    _assert_bit_equal(program.module()(pts, valid), want)
    assert not want[1][1].all() and want[1][0].all()


def _op_cases():
    """(op, args) at test sizes on the CPU, one for each op and option."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    a, b = rand(2, 20, 6), rand(2, 33, 6)
    bv = torch.rand(2, 33, generator=g) > 0.3
    q, k, v = rand(2, 24, 16, 2), rand(2, 20, 16, 2), rand(2, 20, 16, 2)
    kv = torch.rand(2, 20, generator=g) > 0.3
    kv[1] = False
    dout = rand(2, 24, 16, 2)
    out, lse = kattn.flash_cross_attention_plain(q, k, v, kv, 0.25), \
        kattn.flash_cross_attention_lse_plain(q, k, kv, 0.25)
    ca, cb, w = rand(2, 40, 3), rand(2, 40, 3), torch.rand(2, 40, generator=g)
    rs, ts = torch.linalg.qr(rand(2, 9, 3, 3))[0], rand(2, 9, 3)
    vmask = (torch.rand(2, 40, generator=g) > 0.2).float()
    dpc = torch.sqrt(torch.cdist(cb[:, :8], cb[:, :8]) ** 2)
    j = torch.randint(0, 40, (2, 40), generator=g, dtype=torch.int32)
    dmin = torch.rand(2, 40, generator=g) * 2
    icp_valid = torch.rand(2, 40, generator=g) > 0.2
    icp_valid[1] = False
    ops = torch.ops.pose6d_tpu_torch
    return {
        "masked_topk_cdist_k5": (ops.masked_topk_cdist, (a, b, bv, 5)),
        "masked_topk_cdist_k12": (ops.masked_topk_cdist, (a, b, bv, 12)),
        "masked_argmin_cdist": (ops.masked_argmin_cdist, (a, b, bv)),
        "consistency_sum_rank_major": (ops.consistency_sum_rank_major,
                                       (ca, dpc, w, 8)),
        "masked_consistency_sum": (ops.masked_consistency_sum, (ca, cb, w)),
        "ransac_inlier_counts": (ops.ransac_inlier_counts,
                                 (rs, ts, ca, cb, vmask,
                                  torch.tensor([4.0, 9.0]),
                                  torch.tensor([True, False]))),
        "icp_kabsch_update": (ops.icp_kabsch_update,
                              (ca, icp_valid, cb, j, dmin,
                               torch.tensor([1.0, 1.0]), rs[:, 0], ts[:, 0])),
        "flash_cross_attention": (ops.flash_cross_attention,
                                  (q, k, v, kv, 0.25, False)),
        "flash_cross_attention_lse": (ops.flash_cross_attention,
                                      (q, k, v, kv, 0.25, True)),
        "flash_cross_attention_backward": (
            ops.flash_cross_attention_backward,
            (q, k, v, kv, 0.25, out.contiguous(), lse, dout)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_kernel_op_passes_opcheck(case):
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_kernel_op_has_cpu_cuda_and_fake_implementations():
    from torch._library.custom_ops import OPDEFS
    names = ("masked_topk_cdist", "masked_argmin_cdist",
             "consistency_sum_rank_major", "masked_consistency_sum",
             "flash_cross_attention", "flash_cross_attention_backward",
             "ransac_inlier_counts", "icp_kabsch_update")
    for name in names:
        opdef = OPDEFS[f"pose6d_tpu_torch::{name}"]
        assert set(opdef._backend_fns) == {"cpu", "cuda"}, name
        assert opdef._abstract_fn is not None, name


def test_forward_lse_plain_matches_the_kernels_convention():
    """logsumexp over the valid keys of the scaled scores, -inf for a
    query without any (the kernel's lse[r, h] = L > 0 ? M + log L :
    -inf), in float64."""
    q, k, v, kv, scale = _op_cases()["flash_cross_attention_lse"][1][:5]
    _, lse = torch.ops.pose6d_tpu_torch.flash_cross_attention(q, k, v, kv,
                                                              scale, True)
    s = np.einsum("bndh,bmdh->bnhm", q.double().numpy(),
                  k.double().numpy()) * scale
    s = np.where(kv.numpy()[:, None, None, :], s, -np.inf)
    with np.errstate(divide="ignore"):
        m = s.max(-1, keepdims=True)
        want = (np.log(np.exp(s - np.where(np.isinf(m), 0, m)).sum(-1))
                + np.where(np.isinf(m), 0, m)[..., 0])
    # an f32 log-sum-exp of at most 20 terms: a few ulp (~1e-7) of O(1)
    np.testing.assert_allclose(lse[0].numpy(), want[0], rtol=1e-6)
    assert np.isneginf(lse[1].numpy()).all()


def test_candidate_predictor_exports_and_matches_live(monkeypatch):
    """Rotation TTA (2 rotations) and ZoomOut (32) candidates with the
    weak-base gate always engaged: the artifact replays the live request
    bit for bit, through 4 attention nodes (2 forwards) and a RANSAC
    while_loop per candidate."""
    import pose6d_tpu_torch.api as torch_api
    from pose6d_tpu_torch import serving
    from pose6d_tpu_torch.api import Predictor
    from pose6d_tpu_torch.models import DPFMConfig, DPFMNet
    from pose6d_tpu_torch.spectral.operators import point_cloud_operators
    from test_torch_serving import SIZES, frame_inputs, render_frame

    depth, mask, K, verts = render_frame(5)
    monkeypatch.setattr(torch_api, "MAX_RAW", 4096)
    torch.manual_seed(1)
    pred = Predictor(DPFMNet(DPFMConfig(k_eig=32)),
                     {3: point_cloud_operators(verts * 0.1, k_eig=32)},
                     device="cpu", tta_rotations=2, zoomout_k=32,
                     select_trigger=0.0, **SIZES)
    blob = serving.export_predictor(pred, 3, depth.shape)
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph_module.graph.nodes
               if n.op == "call_function"]
    assert targets.count("pose6d_tpu_torch.flash_cross_attention.default") \
        == 4
    # FPS and LOBPCG; RANSAC for the base, ZoomOut and rotated maps; ICP
    # of the winner (3 fine iterations), of the flip bank (2 coarse, 1
    # fine) and of the flip winner (7 coarse, 5 fine)
    assert sum("while_loop" in t for t in targets) == 10
    u = serving.ransac_uniforms(SIZES["ransac_hypotheses"], seed=1,
                                device="cpu")
    out = serving.load_exported(blob, device="cpu")(
        *frame_inputs(depth, mask, K), u)
    live = pred.predict(depth, K, 1.0, [mask], [3], uniforms=[u])[0]
    for k in serving.OUTPUTS:
        np.testing.assert_array_equal(out[k].numpy(), live[k], err_msg=k)
