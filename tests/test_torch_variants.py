"""The model variants of the port on the CPU against the JAX package: every
DPFMNet variant's forward with carried weights, one train step of three
variants, the checkpoints (strict load and round trip, the prefix rule
of the warm start), every config file's model block, the kernel
wrapper's head layout for head dim 32, and the slice as a whole: the
round-4 unseen winner (xyz_hks, weights/synth_unseen300_hks_aug.msgpack)
through the port's Predictor, cached and online, against JAX's."""
import dataclasses
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from scipy.spatial.transform import Rotation

import pose6d_tpu.api as jax_api
import pose6d_tpu.models.attention as jax_attention
import pose6d_tpu_torch.api as torch_api
from pose6d_tpu.api import Predictor as JaxPredictor
from pose6d_tpu.config import Config as JaxFullConfig
from pose6d_tpu.models import DPFMConfig as JaxConfig
from pose6d_tpu.models import DPFMNet as JaxNet
from pose6d_tpu.train import augment as jax_augment
from pose6d_tpu.train import loss as jax_loss
from pose6d_tpu.train.eval_loop import evaluate as jax_evaluate
from pose6d_tpu.train.loop import load_pretrained_params as jax_load_pretrained
from pose6d_tpu.train.train_step import make_train_step
from pose6d_tpu_torch.api import Predictor
from pose6d_tpu_torch.config import Config
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.data.synth import default_intrinsics, rasterize_depth
from pose6d_tpu_torch.models import DPFMConfig, DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.models.port_weights import extend_first_lin_input
from pose6d_tpu_torch.models.weights import (flax_from_state_dict,
                                             read_flax_msgpack,
                                             state_dict_from_flax,
                                             write_flax_msgpack)
from pose6d_tpu_torch.ops.kernels import attention as kattn
from pose6d_tpu_torch.spectral import device_lbo
from pose6d_tpu_torch.spectral.operators import point_cloud_operators
from pose6d_tpu_torch.train import eval_loop, loss
from pose6d_tpu_torch.train.loop import load_pretrained_params, train
from pose6d_tpu_torch.train.train_step import TrainStep
from tests.test_train import make_batch

from test_torch_api import FRAME, _frob_deg
from test_torch_eval import PADS, lm_dataset
from test_torch_train import (ANGLE, LOSS_CFG, TRANS, _flat,
                              _grads_by_flax_name, _torch_batch, jax_draws)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HKS_CKPT = ROOT / "weights" / "synth_unseen300_hks_aug.msgpack"
XYZ_CKPT = ROOT / "weights" / "synth_unseen300.msgpack"
WINNER_YAML = ROOT / "config" / "unseen_lm300_hks_aug180.yaml"
WIDE = dict(n_feat=64, width=128, n_blocks=3, num_heads=4, gnn_dim=64,
            overlap_feat_dim=64)
VARIANTS = {
    "xyz_hks": dict(input_features="xyz_hks"),
    "hks_wks": dict(input_features="hks_wks", c_in=32),
    "wide_4_heads": WIDE,
    "double": dict(attention_type="double"),
    "double_wide": dict(attention_type="double", **WIDE),
    "ratio_0.25": dict(cross_sampling_ratio=0.25),
    "gradient_features": dict(with_gradient_features=True),
    "gradient_features_no_rotations": dict(with_gradient_features=True,
                                           with_gradient_rotations=False),
    "not_robust": dict(robust=False),
}


@pytest.fixture
def f32_refiner(monkeypatch):
    """JAX's XLA attention with its bf16 casts turned into f32 (as
    tests/test_torch_model.py does), in the asking test only."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)


def _toy_grads(rng, v, n, kn=8):
    """Gather-form gradient operators with rows summing to zero (as a
    true gradient's do), zero on padded rows; shape (..., v, kn)."""
    idx = rng.integers(0, n, size=(v, kn)).astype(np.int32)
    idx[:, 0] = np.arange(v)
    cx = rng.normal(size=(v, kn)).astype(np.float32) * 0.1
    cy = rng.normal(size=(v, kn)).astype(np.float32) * 0.1
    cx[:, 0] -= cx.sum(1)
    cy[:, 0] -= cy.sum(1)
    cx[n:] = 0.0
    cy[n:] = 0.0
    return {"grad_idx": idx, "grad_cx": cx, "grad_cy": cy}


def _shape(rng, v, n, grads=False):
    m = np.arange(v) < n
    evecs = np.linalg.qr(rng.normal(size=(v, 64)))[0].astype(np.float32)
    out = {"xyz": ((rng.normal(size=(v, 3)) * 5 + 110) * m[:, None]
                   ).astype(np.float32),
           "mass": ((rng.random(v) + 0.5) * m).astype(np.float32),
           "evals": np.sort(rng.random(64) * 50).astype(np.float32),
           "evecs": evecs * m[:, None], "valid": m}
    if grads:
        out.update(_toy_grads(rng, v, n))
    return out


def _jax_model(kw, cad, pc):
    model = JaxNet(JaxConfig(**kw))
    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    params = jax.device_get(model.init(jax.random.PRNGKey(1), as_j(cad),
                                       as_j(pc)))
    return model, params, as_j


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_matches_jax(name, f32_refiner):
    """Frames of 256 CAD (250 valid) and 128 PC (120 valid) points, JAX's
    init carried into the port strictly. In f32 on both sides the
    outputs differ by summation order: the features and overlaps within
    1e-5 of their max (measured <= 2e-6), C within 1e-3 of max |C| (the
    regularized 30 x 30 solve amplifies the order; measured <= 3e-4)."""
    kw = VARIANTS[name]
    rng = np.random.default_rng(0)
    grads = kw.get("with_gradient_features", False)
    cad, pc = _shape(rng, 256, 250, grads), _shape(rng, 128, 120, grads)
    jm, params, as_j = _jax_model(kw, cad, pc)
    ref = {k: np.asarray(v) for k, v in
           jm.apply(params, as_j(cad), as_j(pc)).items()}
    model = DPFMNet(DPFMConfig(**kw))
    model.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    with torch.no_grad():
        out = model(*({k: torch.as_tensor(v)[None] for k, v in d.items()}
                      for d in (cad, pc)))
    assert sorted(out) == sorted(ref)
    for key, r in ref.items():
        frac = 1e-3 if key == "C" else 1e-5
        np.testing.assert_allclose(out[key][0].numpy(), r, rtol=0,
                                   atol=frac * np.abs(r).max(), err_msg=key)
    if not kw.get("robust", True):      # the fmap head reads the encoder's
        assert not np.array_equal(out["feat1"].numpy(),
                                  out["ref_feat1"].numpy())


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_weights_strict_and_round_trip(name, tmp_path):
    """state_dict_from_flax is strict for each variant's tree (gradient
    features: A_re / A_im or A, bias-free) and flax_from_state_dict gives
    the tree back, through a msgpack file as well."""
    kw = VARIANTS[name]
    rng = np.random.default_rng(1)
    grads = kw.get("with_gradient_features", False)
    cad, pc = _shape(rng, 128, 120, grads), _shape(rng, 64, 60, grads)
    _, params, _ = _jax_model(kw, cad, pc)
    model = DPFMNet(DPFMConfig(**kw))
    model.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    back = _flat(flax_from_state_dict(model.state_dict()))
    ref = _flat(params["params"])
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    if grads:
        names = [k for k in ref if "gradient_features" in k]
        leaf = {"A_re/kernel", "A_im/kernel"} if kw.get(
            "with_gradient_rotations", True) else {"A/kernel"}
        assert {n.split("gradient_features/")[1] for n in names} == leaf
    path = tmp_path / "p.msgpack"
    write_flax_msgpack(path, {"params": flax_from_state_dict(
        model.state_dict())})
    again = load_flax_checkpoint(path, DPFMNet(DPFMConfig(**kw)))
    for k, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k


def _winner_cfg():
    return DPFMConfig.from_yaml_dict(
        yaml.safe_load(WINNER_YAML.read_text())["model"])


def test_hks_winner_loads_strict():
    """The round-4 unseen winner: first_lin (19, 64) = 3 xyz + 16 HKS
    rows, from input_features although its config says C_in: 3."""
    cfg = _winner_cfg()
    assert cfg.input_features == "xyz_hks" and cfg.c_in == 3
    assert cfg.input_width == 19
    model = load_flax_checkpoint(HKS_CKPT, DPFMNet(cfg))
    assert model.feature_extractor.first_lin.weight.shape == (64, 19)
    tree = read_flax_msgpack(HKS_CKPT)["params"]
    back = _flat(flax_from_state_dict(model.state_dict()))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("path", sorted((ROOT / "config").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_from_yaml_dict_matches_jax(path):
    """Every field but use_flash (the port has one attention route on
    the card) equal, and the port's first_lin width the one JAX's Dense
    infers from the channels."""
    block = yaml.safe_load(path.read_text())["model"]
    ours = DPFMConfig.from_yaml_dict(block)
    ref = JaxConfig.from_yaml_dict(block)
    names = {f.name for f in dataclasses.fields(ref)} - {"use_flash"}
    assert {f.name for f in dataclasses.fields(ours)} == names
    for n in names:
        assert getattr(ours, n) == getattr(ref, n), n
    c = ours.input_features
    assert ours.input_width == (3 * ("xyz" in c) + ours.n_hks * ("hks" in c)
                                + ours.n_wks * ("wks" in c))


# -- one train step of three variants against make_train_step -------------

@pytest.mark.parametrize("name", ["xyz_hks", "double", "gradient_features"])
def test_variant_train_step_matches_jax(name, f32_refiner):
    """The loss within 1e-4 and every gradient leaf within 1e-3 of its
    max plus 2e-6 of the step's largest gradient (the bounds of
    tests/test_torch_train.py's default-model step, for the same
    reasons: f32 summation order through the regularized solve, and
    leaves that are 0 in exact arithmetic)."""
    kw = VARIANTS[name]
    rng = np.random.default_rng(0)
    batch = make_batch(rng)
    if kw.get("with_gradient_features"):
        for side, (v, n) in (("cad", (96, 86)), ("pc", (48, 42))):
            g = [_toy_grads(rng, v, n) for _ in range(2)]
            for k in g[0]:
                batch[side][k] = jnp.asarray(np.stack([x[k] for x in g]))
    init_fn, _, fwd_batch = make_train_step(
        JaxConfig(**kw), LOSS_CFG, augment_angle=ANGLE, augment_trans=TRANS)
    state = init_fn(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(10)
    kaug, kloss = jax.random.split(key)
    aug = jax_augment.augment_pc_batch(kaug, batch, ANGLE, TRANS)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: jax_loss.dpfm_loss(kloss, fwd_batch(p, aug), aug,
                                     LOSS_CFG), has_aux=True)(state.params)
    ref_grads = _flat(ref_grads["params"])

    model = DPFMNet(DPFMConfig(**kw))
    model.load_state_dict(state_dict_from_flax(
        jax.device_get(state.params)["params"]), strict=True)
    ts = TrainStep(model, loss.DPFMLossConfig(nce_num_pairs=32),
                   augment_angle=ANGLE, augment_trans=TRANS)
    lval, _, _ = ts.forward_loss(_torch_batch(batch), jax_draws(key, 2, 64))
    ts.backward(lval)
    grads = _grads_by_flax_name(model)
    np.testing.assert_allclose(float(lval), float(ref_loss), rtol=1e-4)
    assert grads.keys() == ref_grads.keys()
    gmax = max(np.abs(r).max() for r in ref_grads.values())
    for n, g in grads.items():
        r = ref_grads[n]
        np.testing.assert_allclose(
            g, r, rtol=0, atol=1e-3 * np.abs(r).max() + 2e-6 * gmax,
            err_msg=n)
    if kw.get("with_gradient_features"):
        assert any(np.abs(g).max() > 0 for n, g in grads.items()
                   if "gradient_features" in n)


# -- warm start: extend_first_lin_input and the prefix rule ---------------

def test_extend_first_lin_input_is_function_preserving():
    """The xyz checkpoint widened by 16 zero rows: the xyz_hks model
    computes exactly the xyz model's features (the HKS channels
    contribute 0 * finite)."""
    rng = np.random.default_rng(2)
    cad, pc = _shape(rng, 128, 120), _shape(rng, 64, 60)
    tree = read_flax_msgpack(XYZ_CKPT)
    wide = extend_first_lin_input(tree, 16)
    assert wide["params"]["feature_extractor"]["first_lin"]["kernel"].shape \
        == (19, 64)
    assert tree["params"]["feature_extractor"]["first_lin"]["kernel"].shape \
        == (3, 64)                                 # the input is not changed
    xyz = DPFMNet()
    xyz.load_state_dict(state_dict_from_flax(tree["params"]), strict=True)
    hks = DPFMNet(DPFMConfig(input_features="xyz_hks"))
    hks.load_state_dict(state_dict_from_flax(wide["params"]), strict=True)
    with torch.no_grad():
        args = [{k: torch.as_tensor(v)[None] for k, v in d.items()}
                for d in (cad, pc)]
        a, b = xyz(*args), hks(*args)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def test_load_pretrained_params_prefix_rule(tmp_path):
    """xyz (3 rows) into xyz_hks (19): widened, as JAX widens it. An
    hks-only checkpoint (16 rows) into xyz_hks: 16 is not a prefix of
    xyz -> hks, refused. xyz into hks_wks: refused. The same xyz weights
    in the reference's weights.pt layout: widened alike."""
    cfg = DPFMConfig(input_features="xyz_hks")
    template = {"params": flax_from_state_dict(DPFMNet(cfg).state_dict())}
    got = load_pretrained_params(str(XYZ_CKPT), template, cfg)
    jtemplate = jax.tree_util.tree_map(jnp.asarray, template)
    ref = jax_load_pretrained(str(XYZ_CKPT), jtemplate,
                              JaxConfig(input_features="xyz_hks"))
    fg, fr = _flat(got["params"]), _flat(ref["params"])
    assert fg.keys() == fr.keys()
    for k in fr:
        np.testing.assert_array_equal(fg[k], np.asarray(fr[k]), err_msg=k)

    hks_only = DPFMNet(DPFMConfig(input_features="hks"))
    path = tmp_path / "hks.msgpack"
    write_flax_msgpack(path, {"params": flax_from_state_dict(
        hks_only.state_dict())})
    with pytest.raises(ValueError, match="not a prefix"):
        load_pretrained_params(str(path), template, cfg)
    cfg2 = DPFMConfig(input_features="hks_wks")
    t2 = {"params": flax_from_state_dict(DPFMNet(cfg2).state_dict())}
    with pytest.raises(ValueError, match="not a prefix"):
        load_pretrained_params(str(XYZ_CKPT), t2, cfg2)
    # the reference's weights.pt layout (xyz, 3 rows) widens the same way
    from test_torch_model_selection import reference_state_dict
    xyz = DPFMNet(DPFMConfig())
    xyz.load_state_dict(state_dict_from_flax(
        read_flax_msgpack(XYZ_CKPT)["params"]))
    torch.save(reference_state_dict(xyz), tmp_path / "weights.pt")
    got_pt = load_pretrained_params(str(tmp_path / "weights.pt"), template,
                                    cfg)
    fp = _flat(got_pt["params"])
    assert fp.keys() == fr.keys()
    for k in fr:
        np.testing.assert_array_equal(fp[k], np.asarray(fr[k]), err_msg=k)


def test_train_warm_starts_hks_model_from_xyz(tmp_path):
    """train() with pretrained = an xyz checkpoint and an xyz_hks model
    (unseen_lm300_hks.yaml's recipe): the HKS rows start at zero, the
    xyz rows at the checkpoint's; one step runs."""
    from pose6d_tpu_torch.data.dataset import gt_object
    items = []
    for cad_ops, pc_ops, obj in lm_dataset(with_K=False)[:1]:
        items += [(cad_ops, pc_ops, obj)] * 2
    cfg = Config()
    cfg.model = DPFMConfig(input_features="xyz_hks")
    cfg.logging_dir = str(tmp_path)
    cfg.train.batch_size, cfg.train.epochs = 2, 1
    cfg.train.pretrained = str(XYZ_CKPT)
    cfg.train.num_threads = 1
    w = read_flax_msgpack(XYZ_CKPT)["params"]["feature_extractor"][
        "first_lin"]["kernel"]
    seen = {}
    orig = TrainStep.__init__

    def spy(self, model, *a, **k):
        seen["w"] = model.feature_extractor.first_lin.weight.detach().clone()
        orig(self, model, *a, **k)
    import pose6d_tpu_torch.train.loop as loop_mod
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_mod.TrainStep, "__init__", spy)
        state = train(cfg, dataset=items, max_steps=1, device="cpu",
                      sample_kw=PADS)
    assert state.step == 1
    np.testing.assert_array_equal(seen["w"][:, :3].numpy(), w.T)
    assert not seen["w"][:, 3:].any()
    del gt_object


# -- the kernel wrapper's head layout at dim 32 -----------------------------

def test_kernel_instance_folds_wide_tokens():
    """The kernels hold at most 32 floats a token: 16 x 1, 16 x 2 and
    32 x 1 launch as they are, wider tokens as one-head frames."""
    assert [kattn.kernel_instance(3, d, h) for d, h in
            ((16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4))] == \
        [(3, 1), (3, 2), (12, 1), (3, 1), (6, 1), (12, 1)]


@pytest.mark.parametrize("bsz,dim,heads", [(1, 32, 2), (1, 32, 4),
                                           (3, 32, 4), (2, 32, 1),
                                           (1, 16, 4)])
def test_head_fold_is_the_same_attention(bsz, dim, heads):
    """For tokens wider than 32 floats the wrapper lays (B, N, dim, H)
    out as (B H, N, dim, 1) frames, contiguous also at B = 1 (where a
    bare reshape is a strided view), with the key mask repeated per
    head. The plain attention and its backward on the folded layout,
    unfolded, equal the unfolded computation."""
    rng = np.random.default_rng(bsz * 10 + heads)
    n, m = 20, 33
    q, k, v = (torch.as_tensor(rng.normal(size=(bsz, s, dim, heads)),
                               dtype=torch.float32) for s in (n, m, m))
    kv = torch.as_tensor(rng.random((bsz, m)) > 0.3)
    kv[0, :] = False                              # a key-less frame
    dout = torch.as_tensor(rng.normal(size=(bsz, n, dim, heads)),
                           dtype=torch.float32)
    folded = [kattn._fold_heads(t) for t in (q, k, v)]
    assert all(t.is_contiguous() for t in folded)
    kvf = kv.repeat_interleave(heads, 0)
    sc = dim ** -0.5
    ref = kattn.flash_cross_attention_plain(q, k, v, kv, sc)
    got = kattn._unfold_heads(
        kattn.flash_cross_attention_plain(*folded, kvf, sc), heads)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    lse = torch.randn(bsz, n, heads)
    assert torch.equal(kattn._unfold_lse(kattn._fold_lse(lse), heads), lse)
    want = kattn.flash_cross_attention_backward_plain(q, k, v, kv, sc, dout)
    grads = kattn.flash_cross_attention_backward_plain(
        *folded, kvf, sc, kattn._fold_heads(dout))
    for a, b in zip(grads, want):
        torch.testing.assert_close(kattn._unfold_heads(a, heads), b, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("bsz,n,m", [(1, 5120, 2048), (2, 2048, 5120),
                                     (16, 5120, 2048), (64, 2560, 2048)])
def test_flash_segments_dim32_cover_every_key_tile(bsz, n, m):
    """The dim-32 instance (256 queries a block, one head) on the H100's
    132 SMs at 2 and 4 resident blocks: every key tile in one segment,
    no segment past the mask words' reach."""
    assert kattn.flash_queries_per_block(1, 32) == 256
    assert kattn.flash_queries_per_block(2, 16) == 256
    tiles = -(-m // kattn.FLASH_KEY_TILE)
    for per_sm in (2, 4):
        g = kattn.flash_segments(bsz, n, m, 1, 132, per_sm, dim=32)
        assert 1 <= g <= tiles
        seen = sorted(t for s in range(g) for t in range(s, tiles, g))
        assert seen == list(range(tiles))
        assert len(range(0, tiles, g)) <= kattn.FLASH_MAX_SEGMENT_TILES


# -- the slice as a whole: the HKS winner through Predictor -----------------

def _winner_params():
    return {"params": serialization.msgpack_restore(
        HKS_CKPT.read_bytes())["params"]}


def _jax_winner_cfg():
    return JaxConfig.from_yaml_dict(
        yaml.safe_load(WINNER_YAML.read_text())["model"])


def test_hks_predictor_cached_matches_jax(f32_refiner):
    """LM obj 11 (CAD cut to 2000 of 5002 points, all 622 observed),
    point-cloud operators, the winner's weights, JAX's RANSAC draws on
    both sides, JAX's attention in f32: the pose within 1 deg and 1 %
    of the diameter. (C differs by f32 summation order, so a few of the
    filter's pairs, and with them RANSAC's inlier count, may differ.)"""
    from pose6d_tpu_torch.data.ply import read_ply
    cad = read_ply(FRAME / "cad_0.ply")["verts"]
    pc = read_ply(FRAME / "pc_0.ply")["verts"]
    sel = np.random.default_rng(0).permutation(len(cad))[:2000]
    cad_ops = point_cloud_operators(cad[sel])
    pc_ops = point_cloud_operators(pc)
    diam = float(np.linalg.norm(cad_ops["xyz"].max(0)
                                - cad_ops["xyz"].min(0)))
    sizes = {"v_cad": 2048, "v_pc": 640}
    ref = JaxPredictor(_winner_params(), {11: cad_ops}, cfg=_jax_winner_cfg(),
                       mode="cached", **sizes
                       ).predict_with_operators(11, pc_ops, seed=0)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(131072 // 512):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.uniform(sub, (512, 3))))
    model = load_flax_checkpoint(HKS_CKPT, DPFMNet(_winner_cfg()))
    out = Predictor(model, {11: cad_ops}, mode="cached", device="cpu",
                    **sizes).predict_with_operators(
        11, pc_ops, uniforms=np.stack(draws))
    assert _frob_deg(out["R"], ref["R"]) < 1.0
    assert np.linalg.norm(out["t"] - ref["t"]) < 0.01 * diam


def test_hks_predictor_online_matches_jax(monkeypatch, f32_refiner):
    """Predictor(mode="online").predict with the winner on a rasterized
    random_shape frame, at the sizes of tests/test_torch_online.py's
    predict test (4096 backprojected points, CAD 640, PC 512 with 500
    sampled, 30 LOBPCG iterations, 512 hypotheses, 5 ICP iterations),
    JAX's LOBPCG start and RANSAC draws on both sides: the pose within
    1 deg and 1 % of the diameter, the same flip hypothesis and inlier
    count. The winner has not seen random shapes, and at these sizes its
    maps are weak on most frames (RANSAC keeps 0-126 inliers of 500), so
    an f32 rounding change can move RANSAC's winner: of the frames of
    seeds 0-20, seed 15's is the one whose port pose and inlier count (19)
    are the same with 1, 2 and 4 CPU threads and that keeps more than 5
    inliers (seed 12's, test_torch_online.py's frame, moves by 105 deg
    with the thread count here)."""
    seed = 15
    verts, faces = random_shape(seed, nu=16, nv=32)
    verts = verts * (140.0 / np.linalg.norm(verts.max(0) - verts.min(0)))
    rng = np.random.default_rng(seed)
    R_gt = Rotation.from_rotvec(rng.normal(size=3) * 0.9).as_matrix()
    t_gt = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                     rng.uniform(900, 1200)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        depth = rasterize_depth(verts, faces, R_gt, t_gt).astype(np.uint16)
    mask = depth > 0
    K = default_intrinsics()
    cad_ops = point_cloud_operators(verts * 0.1)
    diam = float(np.linalg.norm(cad_ops["xyz"].max(0)
                                - cad_ops["xyz"].min(0)))
    sizes = dict(v_cad=640, v_pc=512, max_pc=500, ransac_hypotheses=512,
                 icp_iters=5, lobpcg_iters=30)
    monkeypatch.setattr(jax_api, "MAX_RAW", 4096)
    monkeypatch.setattr(torch_api, "MAX_RAW", 4096)
    jp = JaxPredictor(_winner_params(), {seed: cad_ops},
                      cfg=_jax_winner_cfg(), mode="online", **sizes)
    ref = jp.predict(depth, K, 1.0, [mask], [seed], seed=0)[0]
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    key, sub = jax.random.split(key)
    draws = np.array(jax.random.uniform(sub, (512, 3)))[None]
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (512, 64)))
    monkeypatch.setattr(device_lbo, "default_x0",
                        lambda v, k, device: torch.as_tensor(x0).to(device))
    model = load_flax_checkpoint(HKS_CKPT, DPFMNet(_winner_cfg()))
    out = Predictor(model, {seed: cad_ops}, device="cpu", **sizes).predict(
        depth, K, 1.0, [mask], [seed], uniforms=[draws])[0]
    assert _frob_deg(out["R"], ref["R"]) < 1.0
    assert np.linalg.norm(out["t"] - ref["t"]) < 0.01 * diam
    assert int(out["flip_hypothesis"]) == int(ref["flip_hypothesis"])
    assert int(out["n_inliers"]) == int(ref["n_inliers"])


def test_predictor_refuses_gradient_feature_model():
    """Serving builds no tangent-gradient operators for the cloud: the
    port refuses the model at construction with ValueError; JAX's
    Predictor fails at the first request (its model reads the missing
    grad_idx)."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(80, 3)) * 3
    bank = {1: point_cloud_operators(pts, k_eig=16)}
    cfg = DPFMConfig(with_gradient_features=True, k_eig=16)
    with pytest.raises(ValueError, match="gradient-feature"):
        Predictor(DPFMNet(cfg), bank, mode="cached", device="cpu")
    jcfg = JaxConfig(with_gradient_features=True, k_eig=16)
    cad, pc = _shape(rng, 128, 120, True), _shape(rng, 64, 60, True)
    _, params, _ = _jax_model(dataclasses.asdict(jcfg), cad, pc)
    jp = JaxPredictor(params, bank, cfg=jcfg, mode="cached", v_cad=128,
                      v_pc=128)
    with pytest.raises((KeyError, ValueError)):
        jp.predict_with_operators(1, point_cloud_operators(pts[:60],
                                                           k_eig=16))


def test_evaluate_passes_gradient_operators(tmp_path, f32_refiner):
    """evaluate() with a gradient-feature model on the two LM frames with
    their point-cloud gradient operators: the port's C_pred within 1e-3
    of max |C| and the overlaps within 1e-5 of JAX's (the bounds of the
    forward test above: f32 summation order, amplified in C by the
    regularized solve), and C different when the operators are zeroed
    (so they reach the model)."""
    items = []
    for obj_i, (cad_ops, pc_ops, obj) in enumerate(lm_dataset(False)):
        cad_g = point_cloud_operators(cad_ops["xyz"], build_gradients=True)
        pc_g = point_cloud_operators(pc_ops["xyz"], build_gradients=True)
        keep = ("grad_idx", "grad_cx", "grad_cy")
        items.append(({**cad_ops, **{k: cad_g[k] for k in keep}},
                      {**pc_ops, **{k: pc_g[k] for k in keep}}, obj))
    kw = dict(with_gradient_features=True)
    jcfg, cfg = JaxFullConfig(), Config()
    jcfg.model, cfg.model = JaxConfig(**kw), DPFMConfig(**kw)
    for c in (jcfg, cfg):
        c.pad_v_cad, c.pad_v_pc = PADS["v_cad"], PADS["v_pc"]
        c.eval.batch_size = 2
    rng = np.random.default_rng(5)
    cad, pc = _shape(rng, 128, 120, True), _shape(rng, 64, 60, True)
    _, params, _ = _jax_model(kw, cad, pc)
    jax_evaluate(jcfg, params, dataset=items, save_dir=tmp_path / "jax")
    model = DPFMNet(cfg.model)
    model.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    eval_loop.evaluate(cfg, model, dataset=items, save_dir=tmp_path / "port",
                       device="cpu")
    zeroed = [({**c, "grad_cx": 0 * c["grad_cx"], "grad_cy": 0 * c["grad_cy"]},
               p, o) for c, p, o in items]
    eval_loop.evaluate(cfg, model, dataset=zeroed,
                       save_dir=tmp_path / "zero", device="cpu")
    names = sorted(p.name for p in (tmp_path / "jax").glob("result_*.npz"))
    assert len(names) == 2
    for name in names:
        a = dict(np.load(tmp_path / "jax" / name))
        b = dict(np.load(tmp_path / "port" / name))
        z = dict(np.load(tmp_path / "zero" / name))
        for k, frac in (("C_pred", 1e-3), ("overlap12", 1e-5),
                        ("overlap21", 1e-5)):
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=frac * np.abs(a[k]).max(),
                                       err_msg=k)
        assert np.abs(z["C_pred"] - b["C_pred"]).max() > \
            1e-2 * np.abs(b["C_pred"]).max()


def test_chip_smoke_serves_the_winner_config():
    """chip_smoke.py carries the winner's model block as a literal (the
    GPU host has no PyYAML): it must be the config file's, and every
    variant it drives must build."""
    import chip_smoke
    assert chip_smoke.WINNER_MODEL == yaml.safe_load(
        WINNER_YAML.read_text())["model"]
    assert chip_smoke.WINNER_WEIGHTS == HKS_CKPT
    for kw in [*chip_smoke.VARIANTS.values(), chip_smoke.TRAIN_VARIANT]:
        DPFMNet(DPFMConfig(**kw))
