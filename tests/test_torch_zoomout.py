"""The port's ZoomOut refinement, so3_bank and the geometric flip
disambiguation on the CPU against the JAX package on the same numpy
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu.ops.masking import pad_to
from pose6d_tpu.ops.nn import nearest_valid as jax_nearest_valid
from pose6d_tpu.solvers import multistart as jax_multistart
from pose6d_tpu.solvers.zoomout import zoomout_refine as jax_zoomout
from pose6d_tpu_torch.ops.nn import nearest_valid
from pose6d_tpu_torch.solvers import multistart
from pose6d_tpu_torch.solvers.zoomout import zoomout_refine

from test_multistart import l_shape
from test_torch_online import _angle_deg

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


def test_so3_bank_matches_jax_exactly():
    for n in (1, 4, 10):
        np.testing.assert_array_equal(multistart.so3_bank(n),
                                      jax_multistart.so3_bank(n))
    assert multistart.so3_bank(10).dtype == np.float32


def test_disambiguate_pose_matches_jax():
    """The geometric flip bank on an asymmetric L: one frame starts at
    its observed pose, one from a 180-deg flip of it about the dominant
    principal axis (which the bank must undo). The same hypothesis, R within 0.01 deg; scores within 1e-4
    relative plus the f32 noise of a converged score: it averages square
    roots of |a|^2 - 2 a.b + |b|^2 at |x|^2 ~ 3700 cm^2, which rounds to
    ~8 eps |x|^2, so a perfect fit reads up to sqrt(8 eps |x|^2) ~ 0.04
    cm (measured 0.0019 in JAX, 0.0043 in the port)."""
    pts = l_shape()
    rng = np.random.default_rng(0)
    cad = pad_to(pts, 768)
    cv = np.arange(768) < len(pts)
    R_gt = Rotation.from_rotvec([0.3, -0.5, 0.2]).as_matrix()
    t_gt = np.array([1.0, -2.0, 60.0])
    obs = pts[rng.permutation(len(pts))[:300]] @ R_gt.T + t_gt
    pc = pad_to(obs.astype(np.float32), 384)
    pv = np.arange(384) < 300
    # 180 deg about the L's dominant principal axis, about its centroid
    mu = pts.mean(0)
    axis = np.linalg.eigh(np.cov((pts - mu).T))[1][:, 2]
    flip = Rotation.from_rotvec(np.pi * axis).as_matrix()
    R0s = np.stack([R_gt, R_gt @ flip]).astype(np.float32)
    t0s = np.stack([t_gt, t_gt + R_gt @ mu - R_gt @ flip @ mu]
                   ).astype(np.float32)
    out = multistart.disambiguate_pose(
        _t(np.stack([cad] * 2)), _t(np.stack([cv] * 2)),
        _t(np.stack([pc] * 2)), _t(np.stack([pv] * 2)), _t(R0s), _t(t0s),
        torch.tensor([12.0, 12.0]), icp_iters=15)
    for b in range(2):
        ref = jax_multistart.disambiguate_pose(
            jnp.asarray(cad), jnp.asarray(cv), jnp.asarray(pc),
            jnp.asarray(pv), jnp.asarray(R0s[b]), jnp.asarray(t0s[b]),
            12.0, icp_iters=15)
        assert int(out["hypothesis"][b]) == int(ref["hypothesis"])
        assert _angle_deg(out["R"][b].numpy(), np.asarray(ref["R"])) < 0.01
        noise = np.sqrt(8 * 2.0 ** -24 * (np.abs(pc).max() * np.sqrt(3)) ** 2)
        np.testing.assert_allclose(out["all_scores"][b].numpy(),
                                   np.asarray(ref["all_scores"]), rtol=1e-4,
                                   atol=noise)
        assert _angle_deg(out["R"][b].numpy(), R_gt) < 1.0
    assert out["hypothesis"].tolist() == [0, 3]
