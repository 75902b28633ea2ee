"""The port's ZoomOut refinement, its gate's consistency mean and
so3_bank on the CPU against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu.ops.nn import nearest_valid as jax_nearest_valid
from pose6d_tpu.solvers import fmap2pointmap as jax_fmap
from pose6d_tpu.solvers import multistart as jax_multistart
from pose6d_tpu.solvers.zoomout import zoomout_refine as jax_zoomout
from pose6d_tpu_torch.ops.nn import nearest_valid
from pose6d_tpu_torch.solvers import multistart, zoomout
from pose6d_tpu_torch.solvers.zoomout import zoomout_refine

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pair(seed, v1=240, v2=160, k0=12, k1=28, n_valid=(240, 220)):
    """Two frames of a spectral pair with a known correspondence: the PC
    basis is a row subset of the CAD one (mildly perturbed), the PC cloud
    the matching CAD points under a rigid motion; a noisy k0 x k0 map.
    The second frame pads its CAD rows beyond 220."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("C0", "ex", "ey", "vx", "vy", "cx", "px", "d")}
    for b in range(2):
        ex = np.linalg.qr(rng.normal(size=(v1, k1)))[0].astype(np.float32)
        cx = rng.uniform(-5, 5, size=(v1, 3)).astype(np.float32)
        nv = n_valid[b]
        sel = rng.permutation(nv)[:v2]
        ey = ex[sel] + 0.02 * rng.normal(size=(v2, k1)).astype(np.float32)
        R = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        px = (cx[sel] @ R.T + [0, 0, 50]).astype(np.float32)
        ex[nv:] = 0.0
        cx[nv:] = 0.0
        out["C0"].append((np.eye(k0) + 0.3 * rng.normal(size=(k0, k0))
                          ).astype(np.float32))
        for k, v in (("ex", ex), ("ey", ey.astype(np.float32)),
                     ("vx", np.arange(v1) < nv), ("vy", np.ones(v2, bool)),
                     ("cx", cx), ("px", px)):
            out[k].append(v)
        out["d"].append(np.float32(np.linalg.norm(cx.max(0) - cx.min(0))))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("gate_tau", [0.0, 0.15])
def test_zoomout_refine_matches_jax(gate_tau):
    """Ungated and gated (the consistency mean at 0.15 of the diameter;
    frames where the gate keeps fewer rows than the width fall back):
    C within 1e-4 of JAX's after 4 rounds (12 -> 28 at step 4), and the
    same point map from it."""
    p = _pair(3)
    kw = dict(step=4, gate_tau=gate_tau)
    out = zoomout_refine(_t(p["C0"]), _t(p["ex"]), _t(p["ey"]), _t(p["vx"]),
                         _t(p["vy"]), cad_xyz=_t(p["cx"]),
                         pc_xyz=_t(p["px"]), diam=_t(p["d"]), **kw)
    _, p2p = nearest_valid(_t(p["ey"]), _t(p["ex"]) @ out.transpose(1, 2),
                           _t(p["vx"]))
    for b in range(2):
        ref = jax_zoomout(*(jnp.asarray(p[k][b]) for k in
                            ("C0", "ex", "ey", "vx", "vy")),
                          cad_xyz=jnp.asarray(p["cx"][b]),
                          pc_xyz=jnp.asarray(p["px"][b]),
                          diam=float(p["d"][b]), **kw)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=1e-4)
        _, ref_p2p = jax_nearest_valid(jnp.asarray(p["ey"][b]),
                                       jnp.asarray(p["ex"][b]) @ ref.T,
                                       jnp.asarray(p["vx"][b]))
        np.testing.assert_array_equal(p2p[b].numpy(), np.asarray(ref_p2p))
    assert out.shape == (2, 28, 28)


@pytest.mark.parametrize("rows", ["all_valid", "partial", "none_valid"])
def test_zoomout_gate_mean_matches_jax(rows):
    """The gate's mean over the valid rows (masked_consistency_sum, the
    plain version on the CPU) against the JAX package's exact PC-major
    mean, on a round's matches: the CAD endpoints gathered by a point
    map, the PC ones the cloud ~50 cm down the axis."""
    p = _pair(5)
    rng = np.random.default_rng(6)
    v2 = p["px"].shape[1]
    p2p = rng.integers(0, 220, size=(2, v2))
    ca = np.take_along_axis(p["cx"], p2p[..., None], axis=1)
    valid = {"all_valid": np.ones((2, v2), bool),
             "partial": rng.random((2, v2)) > 0.4,
             "none_valid": np.zeros((2, v2), bool)}[rows]
    out = zoomout._consistency_mean(_t(ca), _t(p["px"]), _t(valid))
    assert out.shape == (2, v2)
    for b in range(2):
        ref = jax_fmap._consistency_mean(jnp.asarray(ca[b]),
                                         jnp.asarray(p["px"][b]),
                                         jnp.asarray(valid[b]))
        # f32 sums of 160 terms in two orders: a few ulps
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=0)
    if rows == "none_valid":
        assert (out == 0).all()


def test_so3_bank_matches_jax_exactly():
    for n in (1, 4, 10):
        np.testing.assert_array_equal(multistart.so3_bank(n),
                                      jax_multistart.so3_bank(n))
    assert multistart.so3_bank(10).dtype == np.float32
