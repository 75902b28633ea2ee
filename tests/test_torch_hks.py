"""The port's heat- and wave-kernel signatures (pose6d_tpu_torch/ops/hks.py)
on the CPU against pose6d_tpu/ops/hks.py, on seeded numpy spectra with
padded rows, and its linspace against jnp.linspace bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops import hks as jax_hks
from pose6d_tpu_torch.ops import hks

torch.set_num_threads(2)


def _spectrum(rng, v, n, k=64, zero_mode=True):
    m = np.arange(v) < n
    evecs = (rng.normal(size=(v, k)) / np.sqrt(n)).astype(np.float32)
    evecs[~m] = 0.0
    evals = np.sort(rng.random(k) * rng.choice([0.5, 50.0])).astype(
        np.float32)
    if zero_mode:                  # the constant mode, ~0 or slightly below
        evals[0] = np.float32(rng.normal() * 1e-7)
    mass = ((rng.random(v) + 0.5) * m).astype(np.float32)
    return evals, evecs, mass, m


@pytest.mark.parametrize("num", [2, 3, 5, 16, 17, 33])
def test_linspace_like_jax_bit_for_bit(num):
    rng = np.random.default_rng(num)
    a = (rng.normal(size=200) * rng.choice([0.1, 5.0, 100.0], 200)).astype(
        np.float32)
    b = (rng.normal(size=200) * rng.choice([0.1, 5.0, 100.0], 200)).astype(
        np.float32)
    got = hks.linspace_like_jax(torch.as_tensor(a), torch.as_tensor(b), num)
    want = np.stack([np.asarray(jnp.linspace(x, y, num)) for x, y in
                     zip(a, b)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn,n", [("heat_kernel_signature", 16),
                                  ("heat_kernel_signature", 8),
                                  ("wave_kernel_signature", 16),
                                  ("wave_kernel_signature", 4)])
def test_signatures_match_jax(fn, n):
    """Three frames of 200 rows (200, 150 and 37 valid). exp, log and the
    (V, K) x (K, T) product round differently in the two libraries:
    within 2e-5 of the largest value (measured <= 5e-7); padded rows
    exactly zero on both."""
    rng = np.random.default_rng(n)
    frames = [_spectrum(rng, 200, nv) for nv in (200, 150, 37)]
    kw = {"n_t": n} if fn.startswith("heat") else {"n_e": n}
    ref = np.stack([np.asarray(getattr(jax_hks, fn)(
        *(jnp.asarray(x) for x in f), **kw)) for f in frames])
    got = getattr(hks, fn)(*(torch.as_tensor(np.stack(x)) for x in
                             zip(*frames)), **kw).numpy()
    assert got.shape == ref.shape == (3, 200, n)
    scale = np.abs(ref).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale.max())
    for i, (_, _, _, m) in enumerate(frames):
        assert not got[i][~m].any() and not ref[i][~m].any()


def test_wks_sigma_clip_and_floors():
    """A flat spectrum (e_max = e_min): sigma clips to delta / 5 = 0,
    below its 1e-3 floor, as jnp.clip does; a frame with no valid row
    hits the mean's 1e-12 floor. Both packages give the same values (the
    flat WKS divides by sigma = 0: NaN on both, where JAX gives it)."""
    rng = np.random.default_rng(3)
    evals, evecs, mass, m = _spectrum(rng, 40, 30)
    flat = np.full_like(evals, 2.0)
    empty = np.zeros_like(m)
    for ev, valid in ((flat, m), (evals, empty)):
        for fn in ("heat_kernel_signature", "wave_kernel_signature"):
            ref = np.asarray(getattr(jax_hks, fn)(
                jnp.asarray(ev), jnp.asarray(evecs), jnp.asarray(mass),
                jnp.asarray(valid)))
            got = getattr(hks, fn)(
                torch.as_tensor(ev)[None], torch.as_tensor(evecs)[None],
                torch.as_tensor(mass)[None], torch.as_tensor(valid)[None])
            np.testing.assert_allclose(got[0].numpy(), ref, rtol=2e-5,
                                       atol=1e-6, equal_nan=True)
