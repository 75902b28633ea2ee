"""The port's model and checkpoint loading on the CPU against the JAX
package: heat diffusion, DPFMNet with weights/synth_seen.msgpack, and
the flax msgpack reader."""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.models import DPFMConfig as JaxConfig
from pose6d_tpu.models import DPFMNet as JaxNet
from pose6d_tpu.spectral.diffusion import heat_diffusion as jax_heat
from pose6d_tpu_torch.models import DPFMNet, load_flax_checkpoint
from pose6d_tpu_torch.models.weights import (read_flax_msgpack,
                                             state_dict_from_flax)
from pose6d_tpu_torch.spectral.diffusion import heat_diffusion

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
CKPT = WEIGHTS / "synth_seen.msgpack"


def _shape(rng, v, n):
    m = np.arange(v) < n
    evecs = np.linalg.qr(rng.normal(size=(v, 64)))[0].astype(np.float32)
    return {"xyz": ((rng.normal(size=(v, 3)) * 5 + 110) * m[:, None]
                    ).astype(np.float32),
            "mass": ((rng.random(v) + 0.5) * m).astype(np.float32),
            "evals": np.sort(rng.random(64) * 50).astype(np.float32),
            "evecs": evecs * m[:, None], "valid": m}


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    cad, pc = _shape(rng, 256, 250), _shape(rng, 128, 120)
    model = load_flax_checkpoint(CKPT, DPFMNet())
    with torch.no_grad():
        out = model({k: torch.as_tensor(v)[None] for k, v in cad.items()},
                    {k: torch.as_tensor(v)[None] for k, v in pc.items()})
    params = {"params": serialization.msgpack_restore(
        CKPT.read_bytes())["params"]}
    return cad, pc, params, {k: v[0].numpy() for k, v in out.items()}


def _jax_forward(cad, pc, params):
    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    out = JaxNet(JaxConfig()).apply(params, as_j(cad), as_j(pc))
    return {k: np.asarray(v) for k, v in out.items()}


def test_heat_diffusion_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    time = np.abs(rng.normal(size=8)).astype(np.float32)
    time[0] = -1.0                   # clamped to 1e-8 on both sides
    mass = rng.random(50).astype(np.float32)
    evals = np.sort(rng.random(16) * 10).astype(np.float32)
    evecs = rng.normal(size=(50, 16)).astype(np.float32)
    ref = jax_heat(*(jnp.asarray(a) for a in (x, time, mass, evals, evecs)))
    out = heat_diffusion(*(torch.as_tensor(a)[None] if a is not time
                           else torch.as_tensor(a)
                           for a in (x, time, mass, evals, evecs)))
    # three f32 matmuls of width <= 50
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_dpfm_matches_jax_f32(frame, monkeypatch):
    """With the XLA branch's bf16 casts turned into f32 (in this test
    only), the JAX forward and the port compute the same f32 function."""
    cad, pc, params, out = frame
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_attention, "jnp", proxy)
    ref = _jax_forward(cad, pc, params)
    # f32 summation order only; the 30x30 regularized solve amplifies
    # it (measured ~5e-5 of max |C|)
    for key in ("C", "overlap12", "overlap21", "feat1", "feat2"):
        np.testing.assert_allclose(out[key], ref[key], rtol=0,
                                   atol=1e-3 * np.abs(ref[key]).max(),
                                   err_msg=key)


def test_dpfm_matches_jax_xla_branch(frame):
    """Against the unmodified XLA branch, which rounds q, k, v and the
    probabilities to bf16 (models/attention.py:111-117)."""
    cad, pc, params, out = frame
    ref = _jax_forward(cad, pc, params)
    # bf16 (relative 2^-8) in the refiner: features move by ~0.3 % of
    # their range, overlaps (sigmoids) by ~2e-3, and the regularized
    # solve amplifies it to ~3 % of max |C| (measured); bounds 2x that
    bounds = {"C": 6e-2, "overlap12": 1e-2, "overlap21": 1e-2,
              "feat1": 1e-2, "feat2": 1e-2}
    for key, frac in bounds.items():
        np.testing.assert_allclose(out[key], ref[key], rtol=0,
                                   atol=frac * np.abs(ref[key]).max(),
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        WEIGHTS.glob("*.msgpack")))
def test_msgpack_reader_matches_flax(name):
    path = WEIGHTS / name
    ours = read_flax_msgpack(path)
    ref = serialization.msgpack_restore(path.read_bytes())
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_state_dict_loads_strict():
    params = read_flax_msgpack(CKPT)["params"]
    sd = state_dict_from_flax(params)
    assert len(sd) == 38
    model = DPFMNet()
    model.load_state_dict(sd, strict=True)
    w = params["feature_extractor"]["first_lin"]["kernel"]
    np.testing.assert_array_equal(
        model.feature_extractor.first_lin.weight.detach().numpy(), w.T)
