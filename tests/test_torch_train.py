"""The port's training path on the CPU against the JAX package on the
same numpy inputs and the same key-derived draws: losses, augmentation,
one train step (loss and every gradient leaf), three steps (params),
flax-like init, checkpoints both ways, the pipeline and the loop."""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.data import pipeline as jax_pipeline
from pose6d_tpu.data.dataset import BOPObjectDataset
from pose6d_tpu.models import DPFMConfig as JaxConfig
from pose6d_tpu.models import DPFMNet as JaxNet
from pose6d_tpu.ops import geometry as jax_geometry
from pose6d_tpu.train import augment as jax_augment
from pose6d_tpu.train import checkpoint as jax_checkpoint
from pose6d_tpu.train import loss as jax_loss
from pose6d_tpu.train import metrics as jax_metrics
from pose6d_tpu.train.train_step import make_train_step
from pose6d_tpu_torch.config import Config
from pose6d_tpu_torch.data import pipeline
from pose6d_tpu_torch.data.dataset import gt_correspondences, gt_object
from pose6d_tpu_torch.models import DPFMNet, init_like_flax
from pose6d_tpu_torch.models.weights import (flax_from_state_dict,
                                             read_flax_msgpack,
                                             state_dict_from_flax,
                                             write_flax_msgpack)
from pose6d_tpu_torch.ops.geometry import radius_correspondence_mask
from pose6d_tpu_torch.train import augment, loss
from pose6d_tpu_torch.train.checkpoint import save_params
from pose6d_tpu_torch.train.loop import train
from pose6d_tpu_torch.train.metrics import inlier_ratio
from pose6d_tpu_torch.train.train_step import TrainStep
from tests.test_train import make_batch

torch.set_num_threads(2)

ANGLE, TRANS = float(np.deg2rad(60)), 2.0
LOSS_CFG = jax_loss.DPFMLossConfig(nce_num_pairs=32)


@pytest.fixture
def f32_refiner(monkeypatch):
    """Turn the JAX XLA attention branch's bf16 casts into f32, in the
    test that asks for it only (as tests/test_torch_model.py does)."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)


def _torch_batch(batch):
    return jax.tree_util.tree_map(lambda x: torch.as_tensor(np.asarray(x)),
                                  batch)


def jax_draws(key, bsz, n_slots, angle=ANGLE, trans=TRANS):
    """The draws make_train_step's step_fn makes from `key`, in its key
    order (augmentation key first, then the loss key)."""
    kaug, kloss = jax.random.split(key)
    axis, ang, tr = [], [], []
    for k in jax.random.split(kaug, bsz):
        kr, kt = jax.random.split(k)
        k1, k2 = jax.random.split(kr)
        axis.append(jax.random.normal(k1, (3,)))
        ang.append(jax.random.uniform(k2, (), minval=0.0, maxval=angle))
        tr.append(jax.random.uniform(kt, (3,), minval=-trans, maxval=trans))
    gumbel = [jax.random.gumbel(k, (n_slots,))
              for k in jax.random.split(kloss, bsz)]
    as_t = lambda xs: torch.as_tensor(np.stack(xs))  # noqa: E731
    return {"axis": as_t(axis), "angle": as_t(ang), "trans": as_t(tr),
            "gumbel": as_t(gumbel)}


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, prefix + name + "/"))
        else:
            out[prefix + name] = np.asarray(leaf)
    return out


# -- losses ---------------------------------------------------------------

def _outputs(rng, bsz=2, v1=96, v2=48, c=32):
    return {"C": rng.normal(size=(bsz, 30, 30)).astype(np.float32) * 0.3,
            "overlap12": rng.random((bsz, v1)).astype(np.float32),
            "overlap21": rng.random((bsz, v2)).astype(np.float32),
            "feat1": rng.normal(size=(bsz, v1, c)).astype(np.float32),
            "feat2": rng.normal(size=(bsz, v2, c)).astype(np.float32)}


def test_loss_terms_match_jax():
    rng = np.random.default_rng(0)
    batch = make_batch(rng)
    out = _outputs(rng)
    key = jax.random.PRNGKey(3)
    gumbel = jax_draws(key, 2, 64)["gumbel"]
    # the JAX loss draws its Gumbels from the loss key: the same ones
    _, kloss = jax.random.split(key)
    tb, to = _torch_batch(batch), _torch_batch(out)

    c_gt = loss.solve_c_gt(tb["cgt_A"], tb["cgt_B"])
    ref = jax.vmap(jax_loss.solve_c_gt)(batch["cgt_A"], batch["cgt_B"])
    # a 30x30 f32 solve (cond ~1e2), LAPACK in both
    np.testing.assert_allclose(c_gt.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        loss.frobenius_loss(to["C"], c_gt).numpy(),
        np.asarray(jax_loss.frobenius_loss(out["C"], ref)), rtol=1e-5)
    np.testing.assert_allclose(
        loss.weighted_bce(to["overlap12"], tb["overlap12"],
                          tb["cad"]["valid"]).numpy(),
        np.asarray(jax.vmap(jax_loss.weighted_bce)(
            out["overlap12"], batch["overlap12"], batch["cad"]["valid"])),
        rtol=1e-5)
    nce = loss.nce_softmax_loss(gumbel, to["feat1"], to["feat2"],
                                tb["pairs"], tb["pairs_valid"], 0.07, 32)
    ref_nce = jax.vmap(lambda k, f1, f2, p, pv: jax_loss.nce_softmax_loss(
        k, f1, f2, p, pv, 0.07, 32))(
        jax.random.split(kloss, 2), out["feat1"], out["feat2"],
        batch["pairs"], batch["pairs_valid"])
    # same 32 pairs selected; logits of O(30) through a log-softmax
    np.testing.assert_allclose(nce.numpy(), np.asarray(ref_nce), rtol=1e-5)
    total, logs = loss.dpfm_loss(to, tb, gumbel,
                                 loss.DPFMLossConfig(nce_num_pairs=32))
    ref_total, ref_logs = jax_loss.dpfm_loss(kloss, out, batch, LOSS_CFG)
    for k in ("loss", "fmap_loss", "acc_loss", "nce_loss"):
        np.testing.assert_allclose(float(logs[k]), float(ref_logs[k]),
                                   rtol=1e-5, err_msg=k)


def test_augment_matches_jax():
    rng = np.random.default_rng(1)
    batch = make_batch(rng, B=3)
    key = jax.random.PRNGKey(5)
    kaug, _ = jax.random.split(key)
    ref = jax_augment.augment_pc_batch(kaug, batch, ANGLE, TRANS)
    out = augment.augment_pc_batch(_torch_batch(batch), ANGLE, TRANS,
                                   jax_draws(key, 3, 64))
    # a 3x3 rotation about the centroid of points ~110 cm out, in f32
    np.testing.assert_allclose(out["pc"]["xyz"].numpy(),
                               np.asarray(ref["pc"]["xyz"]), atol=1e-4)
    assert augment.augment_pc_batch(batch, 0.0, 0.0) is batch


# -- one train step and three, against make_train_step ---------------------

def _grads_by_flax_name(model):
    return _flat(flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}))


def test_train_step_matches_jax(f32_refiner):
    rng = np.random.default_rng(0)
    batch = make_batch(rng)
    init_fn, step_fn, fwd_batch = make_train_step(
        JaxConfig(), LOSS_CFG, augment_angle=ANGLE, augment_trans=TRANS)
    state = init_fn(jax.random.PRNGKey(0), batch)
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]

    kaug, kloss = jax.random.split(keys[0])
    aug = jax_augment.augment_pc_batch(kaug, batch, ANGLE, TRANS)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: jax_loss.dpfm_loss(kloss, fwd_batch(p, aug), aug,
                                     LOSS_CFG), has_aux=True)(state.params)
    ref_grads = _flat(ref_grads["params"])
    step = jax.jit(step_fn)
    states = [state]
    for k in keys:
        states.append(step(states[-1], batch, k)[0])

    model = DPFMNet()
    model.load_state_dict(state_dict_from_flax(
        jax.device_get(state.params)["params"]))
    ts = TrainStep(model, loss.DPFMLossConfig(nce_num_pairs=32),
                   augment_angle=ANGLE, augment_trans=TRANS)
    tb = _torch_batch(batch)
    draws = [jax_draws(k, 2, 64) for k in keys]
    lval, _, _ = ts.forward_loss(tb, draws[0])
    ts.backward(lval)
    grads = _grads_by_flax_name(model)
    # f32 on both sides; the 30x30 regularized fmap solve amplifies
    # summation-order noise (forward C agrees to ~5e-5 of max |C|,
    # tests/test_torch_model.py). Gradients: to 1e-3 of each leaf's max,
    # plus 2e-6 of the step's largest gradient for the leaves whose
    # gradient is zero up to that noise (proj_k's bias is exactly 0 in
    # exact arithmetic: a softmax does not see a shift of all its keys)
    np.testing.assert_allclose(float(lval), float(ref_loss), rtol=1e-4)
    assert grads.keys() == ref_grads.keys() and len(grads) == 38
    gmax = max(np.abs(r).max() for r in ref_grads.values())
    for name, g in grads.items():
        r = ref_grads[name]
        np.testing.assert_allclose(
            g, r, rtol=0, atol=1e-3 * np.abs(r).max() + 2e-6 * gmax,
            err_msg=name)

    ref_losses = [float(step(s, batch, k)[1]["loss"])
                  for s, k in zip(states, keys)]
    for i in range(3):
        logs = ts(tb, i, draws[i])
        assert np.isfinite(float(logs["grad_norm"]))
        # after an RMSprop update, 1/sqrt(nu) amplifies near-zero-gradient
        # noise; the same bound as tests/test_train.py's mesh-vs-single
        np.testing.assert_allclose(float(logs["loss"]), ref_losses[i],
                                   rtol=1e-4 if i == 0 else 0.05)
    params = _flat(flax_from_state_dict(model.state_dict()))
    ref_params = _flat(jax.device_get(states[-1].params)["params"])
    # RMSprop's first step is ~lr * 10 * sign(g) = 5e-3: where |g| is
    # near 0 the sign is noise, and those flips feed the next two steps'
    # gradients. So: elements whose first gradient is clear of the noise
    # agree to within 2e-2 (tests/test_train.py bounds the same drift by
    # 0.05 after two steps), and their median to a tenth of one step
    diffs = []
    for name, p in params.items():
        g = ref_grads[name]
        clear = np.abs(g) > 1e-2 * np.abs(g).max()
        np.testing.assert_allclose(p[clear], ref_params[name][clear],
                                   rtol=0, atol=2e-2, err_msg=name)
        diffs.append(np.abs(p[clear] - ref_params[name][clear]))
    assert np.median(np.concatenate(diffs)) < 5e-4


# -- init, checkpoints ------------------------------------------------------

def test_init_like_flax_matches_lecun_normal():
    """Per-layer std against flax's lecun_normal (variance 1 / fan_in,
    truncated at 2 std), zero biases and diffusion times."""
    model = init_like_flax(DPFMNet(), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batch = make_batch(rng)
    one = jax.tree_util.tree_map(lambda x: x[0], batch)
    ref = _flat(JaxNet(JaxConfig()).init(jax.random.PRNGKey(0), one["cad"],
                                         one["pc"])["params"])
    ours = _flat(flax_from_state_dict(model.state_dict()))
    assert ours.keys() == ref.keys()
    pool, ref_pool = [], []
    for name, w in ours.items():
        if not name.endswith("kernel"):
            assert not w.any(), name          # bias / diffusion_time
            assert not ref[name].any(), name
            continue
        std = (1.0 / w.shape[0]) ** 0.5
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
        pool.append(w.ravel() / std)
        ref_pool.append(ref[name].ravel() / std)
        if w.size >= 1000:
            # sampling error of a std over n draws ~ 1 / sqrt(2n); 5 sigma
            tol = 5 / np.sqrt(2 * w.size)
            assert abs(w.std() / std - 1) < tol, name
            assert abs(ref[name].std() / std - 1) < tol, name
    pool, ref_pool = np.concatenate(pool), np.concatenate(ref_pool)
    tol = 5 / np.sqrt(2 * pool.size)
    assert abs(pool.std() - 1) < tol and abs(ref_pool.std() - 1) < tol
    # the same truncated shape: matching quantiles of the pooled draws
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(pool, qs),
                               np.quantile(ref_pool, qs), atol=0.05)


def test_save_params_round_trips_through_flax(tmp_path):
    model = init_like_flax(DPFMNet(), torch.Generator().manual_seed(1))
    path = tmp_path / "params.msgpack"
    save_params(path, model)
    tree = flax_from_state_dict(model.state_dict())
    # byte for byte what flax.serialization writes for the same tree
    assert path.read_bytes() == serialization.to_bytes({"params": tree})
    restored = serialization.msgpack_restore(path.read_bytes())
    rng = np.random.default_rng(3)
    one = jax.tree_util.tree_map(lambda x: x[0], make_batch(rng))
    template = JaxNet(JaxConfig()).init(jax.random.PRNGKey(0), one["cad"],
                                        one["pc"])
    loaded = jax_checkpoint.load_params(path, template)
    sd = model.state_dict()
    for got in (_flat(restored["params"]), _flat(loaded["params"]),
                _flat(read_flax_msgpack(path)["params"])):
        want = _flat(tree)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], want[name])
    back = state_dict_from_flax(read_flax_msgpack(path)["params"])
    for name, t in sd.items():
        assert torch.equal(back[name], t), name


def test_msgpack_writer_sizes(tmp_path):
    """Every msgpack width class the writer emits reads back through
    flax: fix/8/16-bit maps, strings, bins and ints."""
    tree = {"a" * 40: np.arange(300, dtype=np.float32),
            "m": {f"k{i:02d}": np.full((), i, np.float32)
                  for i in range(20)},
            "big": np.zeros((70000,), np.float32),
            "s": np.ones((2, 200), np.float32)}
    path = tmp_path / "t.msgpack"
    write_flax_msgpack(path, tree)
    assert path.read_bytes() == serialization.to_bytes(tree)
    back = serialization.msgpack_restore(path.read_bytes())
    for name, want in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[name], want)


# -- pipeline and GT ---------------------------------------------------------

def _frame(seed, vc=300, vp=120):
    import __graft_entry__ as ge
    cad, pc, _ = ge._RawSynthDataset(seed + 1, vc=vc, vp=vp)[seed]
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.linalg.det(R)
    t = rng.normal(size=3) * 10 + np.array([0, 0, 100.0])
    obs = cad["xyz"][rng.permutation(vc)[:vp]] @ R.T + t
    pc = dict(pc, xyz=(obs + rng.normal(size=obs.shape) * 0.2
                       ).astype(np.float32))
    diam = float(np.linalg.norm(cad["xyz"].max(0) - cad["xyz"].min(0)))
    return cad, pc, R, t, diam


def test_radius_mask_and_gt_correspondences_match_jax():
    cad, pc, R, t, diam = _frame(0)
    align = (pc["xyz"].astype(np.float64) - t) @ R
    radius = diam * 0.05
    valid1 = np.arange(len(cad["xyz"])) < 280
    valid2 = np.arange(len(align)) < 110
    ref = jax_geometry.radius_correspondence_mask(
        jnp.asarray(cad["xyz"]), jnp.asarray(valid1),
        jnp.asarray(align, jnp.float32), jnp.asarray(valid2), radius)
    m = radius_correspondence_mask(
        torch.as_tensor(cad["xyz"]), torch.as_tensor(valid1),
        torch.as_tensor(align.astype(np.float32)), torch.as_tensor(valid2),
        radius)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref))
    pairs, o12, o21 = gt_correspondences(cad["xyz"], align, radius)
    rp, r12, r21 = BOPObjectDataset._gt_correspondences(None, cad["xyz"],
                                                        align, radius)
    assert len(pairs) > 50
    for a, b in ((pairs, rp), (o12, r12), (o21, r21)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    obj = gt_object(cad["xyz"], pc["xyz"], R, t, diam, obj_id=3)
    np.testing.assert_array_equal(obj["P"], rp)
    np.testing.assert_allclose(obj["align_pc"], align.astype(np.float32))


def test_make_sample_collate_loader_match_jax():
    frames = [_frame(s) for s in range(4)]
    items = [(cad, pc, gt_object(cad["xyz"], pc["xyz"], R, t, diam, s))
             for s, (cad, pc, R, t, diam) in enumerate(frames)]
    kw = {"v_cad": 320, "v_pc": 128, "nce_pairs": 64}
    for cad, pc, obj in items:
        a = pipeline.make_sample(cad, pc, obj, np.random.default_rng(7), **kw)
        b = jax_pipeline.make_sample(cad, pc, obj, np.random.default_rng(7),
                                     **kw)
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    ours = list(pipeline.HostLoader(items, 2, seed=3, num_threads=2, **kw))
    ref = list(jax_pipeline.HostLoader(items, 2, seed=3, num_threads=2, **kw))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_inlier_ratio_matches_jax():
    rng = np.random.default_rng(4)
    cad = rng.normal(size=(2, 50, 3)).astype(np.float32)
    pc = rng.normal(size=(2, 40, 3)).astype(np.float32)
    pairs = np.stack([rng.integers(0, 50, (2, 40)),
                      np.tile(np.arange(40), (2, 1))], 1).astype(np.int32)
    pv = rng.random((2, 40)) > 0.2
    thr = np.array([1.0, 1.5], np.float32)
    ref = jax.vmap(jax_metrics.inlier_ratio)(*(jnp.asarray(x) for x in (
        pairs, pv, cad, pc, thr)))
    out = inlier_ratio(*(torch.as_tensor(x) for x in (pairs, pv, cad, pc,
                                                       thr)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


# -- the loop --------------------------------------------------------------

def _cfg(tmp_path, **train_kw):
    cfg = Config()
    cfg.logging_dir = str(tmp_path)
    cfg.train.batch_size = 4
    cfg.train.epochs = 2
    cfg.train.num_threads = 2
    cfg.train.log_ir = True
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    cfg.loss = dataclasses.replace(cfg.loss, nce_num_pairs=32)
    return cfg


_KW = {"v_cad": 128, "v_pc": 64, "nce_pairs": 64}


def _records(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_train_loop_cpu_writes_metrics(tmp_path):
    import __graft_entry__ as ge
    state = train(_cfg(tmp_path, augment_rotation_deg=30.0),
                  dataset=ge._RawSynthDataset(8, vc=96, vp=48), max_steps=2,
                  sample_kw=_KW, device="cpu")
    assert state.step == 2
    (run,) = tmp_path.iterdir()
    steps = [r for r in _records(run) if "step" in r]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        for k in ("loss", "fmap_loss", "acc_loss", "nce_loss", "grad_norm",
                  "IR"):
            assert np.isfinite(r[k]), k
    assert (run / "params_latest.msgpack").exists()


def test_train_loop_resumes_from_checkpoint(tmp_path):
    import __graft_entry__ as ge
    ds = ge._RawSynthDataset(8, vc=96, vp=48)
    run = tmp_path / "run"
    s1 = train(_cfg(tmp_path, resume_dir=str(run)), dataset=ds,
               max_steps=2, sample_kw=_KW, device="cpu")
    saved = torch.load(run / "ckpt" / "ckpt_00000002.pt", weights_only=True)
    sq = {k: v["square_avg"].clone()
          for k, v in saved["optimizer"]["state"].items()}
    s2 = train(_cfg(tmp_path, resume_dir=str(run)), dataset=ds,
               max_steps=3, sample_kw=_KW, device="cpu")
    assert s1.step == 2 and s2.step == 3
    assert [r["step"] for r in _records(run) if "step" in r] == [0, 1, 2]
    state = s2.optimizer.state_dict()["state"]
    for k, v in state.items():
        assert float(v["step"]) == 3.0
        # one more update of the restored square average (0.99 sq + 0.01
        # g^2), not a fresh one (0.01 g^2)
        assert bool((v["square_avg"] >= 0.99 * sq[k] - 1e-12).all())
    assert any(not torch.equal(v["square_avg"], sq[k])
               for k, v in state.items())
    assert any(bool(sq[k].gt(0).any()) for k in sq)
