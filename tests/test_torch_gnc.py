"""The port's GNC-TLS solver and its consistency core on the CPU against
the JAX package on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu.solvers import gnc as jax_gnc
from pose6d_tpu_torch.solvers import gnc

from test_torch_online import _angle_deg

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _correspondences(seed, n=400, n_valid=360, inlier_frac=0.4,
                     noise=0.01):
    """A planted rigid motion: the first inlier_frac of the valid pairs
    follow it with `noise` (cm), the rest are uniform outliers in the
    same 20 cm box; padded rows beyond n_valid."""
    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    t = rng.normal(size=3) * 5 + [0, 0, 60]
    src = rng.uniform(-10, 10, size=(n, 3))
    dst = src @ R.T + t + rng.normal(size=(n, 3)) * noise
    n_in = int(inlier_frac * n_valid)
    dst[n_in:] = rng.uniform(-10, 10, size=(n - n_in, 3)) + t
    perm = rng.permutation(n_valid)
    src[:n_valid], dst[:n_valid] = src[perm], dst[perm]
    valid = np.arange(n) < n_valid
    return (src.astype(np.float32), dst.astype(np.float32), valid,
            R.astype(np.float32), t.astype(np.float32), perm < n_in)


def test_consistency_core_matches_jax_on_planted_clique():
    """Two frames with 40 % and 25 % planted inliers: the same surviving
    mask after 6 peeling rounds, and it keeps the inliers."""
    frames = [_correspondences(1), _correspondences(2, inlier_frac=0.25)]
    src, dst, valid = (np.stack([f[i] for f in frames]) for i in range(3))
    out = gnc.consistency_core(_t(src), _t(dst), _t(valid), noise_bound=0.05,
                               row_block=128)
    for b, f in enumerate(frames):
        ref = jax_gnc.consistency_core(jnp.asarray(src[b]),
                                       jnp.asarray(dst[b]),
                                       jnp.asarray(valid[b]),
                                       noise_bound=0.05, row_block=128)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))
        inl = np.zeros(len(valid[b]), bool)
        inl[:360] = f[5]
        assert out[b].numpy()[inl].all()
        assert out[b].sum() < 0.5 * valid[b].sum()


def test_gnc_least_squares_init_matches_jax():
    """key=None (least-squares seed) on mildly contaminated pairs (90 %
    inliers), two frames: R within 1e-4 rad of JAX's, t within 1e-4 cm,
    the same inliers, each frame stopping on its own, both within 1 deg
    of the planted motion."""
    frames = [_correspondences(3, inlier_frac=0.9),
              _correspondences(4, inlier_frac=0.9, noise=0.02)]
    src, dst, valid = (np.stack([f[i] for f in frames]) for i in range(3))
    out = gnc.gnc_tls_pose(_t(src), _t(dst), _t(valid))
    for b in range(2):
        ref = jax_gnc.gnc_tls_pose(jnp.asarray(src[b]), jnp.asarray(dst[b]),
                                   jnp.asarray(valid[b]))
        assert np.deg2rad(_angle_deg(out["R"][b].numpy(),
                                     np.asarray(ref["R"]))) < 1e-4
        np.testing.assert_allclose(out["t"][b].numpy(), np.asarray(ref["t"]),
                                   atol=1e-4)
        np.testing.assert_array_equal(out["inliers"][b].numpy(),
                                      np.asarray(ref["inliers"]))
        assert int(out["n_inliers"][b]) == int(ref["n_inliers"])
        assert _angle_deg(out["R"][b].numpy(), frames[b][3]) < 1.0
    assert out["iterations"].min() > 1


@pytest.mark.parametrize("core", [False, True])
def test_gnc_triad_init_with_jax_draws_matches_jax(core):
    """With a key: JAX's uniform draw (8 blocks x 512 x 3) handed to the
    port; 25 % inliers, which the least-squares seed cannot take. R
    within 1e-4 rad, the same inlier set; with and without the
    consistency core."""
    frames = [_correspondences(5, inlier_frac=0.25),
              _correspondences(6, inlier_frac=0.3)]
    src, dst, valid = (np.stack([f[i] for f in frames]) for i in range(3))
    keys = [jax.random.PRNGKey(10 + b) for b in range(2)]
    draws = np.stack([np.asarray(jax.random.uniform(k, (8, 512, 3)))
                      for k in keys])
    out = gnc.gnc_tls_pose(_t(src), _t(dst), _t(valid), uniforms=_t(draws),
                           core_select=core)
    for b in range(2):
        ref = jax_gnc.gnc_tls_pose(jnp.asarray(src[b]), jnp.asarray(dst[b]),
                                   jnp.asarray(valid[b]), key=keys[b],
                                   core_select=core)
        assert np.deg2rad(_angle_deg(out["R"][b].numpy(),
                                     np.asarray(ref["R"]))) < 1e-4
        np.testing.assert_array_equal(out["inliers"][b].numpy(),
                                      np.asarray(ref["inliers"]))
        assert _angle_deg(out["R"][b].numpy(), frames[b][3]) < 0.1
