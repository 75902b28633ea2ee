"""The port's flip disambiguation on the CPU against the JAX package on
the same numpy inputs: symmetry detection and the flip bank (host
numpy), the z-buffer and depth score, the hypothesis bank and
disambiguate_pose_depth; and the host copy of random_shape."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu.ops import symmetry as jax_symmetry
from pose6d_tpu.ops.masking import pad_to
from pose6d_tpu.solvers import multistart as jax_multistart
from pose6d_tpu.solvers import verify_pose as jax_verify
from pose6d_tpu_torch.data.shapes import random_shape
from pose6d_tpu_torch.ops import symmetry
from pose6d_tpu_torch.solvers import multistart, verify_pose

from test_multistart import K as K_JAX
from test_multistart import l_shape, render_obs
from test_torch_online import _angle_deg

torch.set_num_threads(2)
K_NP = np.asarray(K_JAX)


def _t(x):
    return torch.as_tensor(np.array(x))


def _shapes():
    """An asymmetric L, a box surface (three C2 axes) and a cylinder
    wall (a revolution axis), each ~10 cm."""
    rng = np.random.default_rng(0)
    half = np.array([6.0, 3.0, 1.5])
    box = rng.uniform(-1, 1, size=(1000, 3)) * half
    face = rng.integers(0, 3, 1000)
    box[np.arange(1000), face] = np.sign(rng.normal(size=1000)) * half[face]
    ang = rng.uniform(0, 2 * np.pi, 1000)
    cyl = np.stack([2 * np.cos(ang), 2 * np.sin(ang),
                    rng.uniform(-5, 5, 1000)], 1)
    return {"l_shape": l_shape().astype(np.float64),
            "box": box, "cylinder": cyl}


@pytest.mark.parametrize("name", ["l_shape", "box", "cylinder"])
def test_symmetry_detection_and_bank_match_jax(name):
    """detect_symmetries and disambiguation_bank (host numpy copies)
    equal to 1e-6; sym_rotation_error_deg too."""
    verts = _shapes()[name]
    Rs, rep = symmetry.detect_symmetries(verts)
    ref_Rs, ref_rep = jax_symmetry.detect_symmetries(verts)
    np.testing.assert_allclose(Rs, ref_Rs, atol=1e-6)
    assert [(r["order"], r["continuous"]) for r in rep] == \
        [(r["order"], r["continuous"]) for r in ref_rep]
    bank = symmetry.disambiguation_bank(verts, max_rots=6)
    np.testing.assert_allclose(
        bank, jax_symmetry.disambiguation_bank(verts, max_rots=6), atol=1e-6)
    R_gt = Rotation.from_rotvec([0.4, -0.2, 0.9]).as_matrix()
    R_est = R_gt @ bank[min(1, len(bank) - 1)]
    assert abs(symmetry.sym_rotation_error_deg(R_gt, R_est, Rs)
               - jax_symmetry.sym_rotation_error_deg(R_gt, R_est,
                                                     ref_Rs)) < 1e-6
    if name == "cylinder":
        assert any(r["continuous"] for r in rep)


def _posed_l(rotvecs, ts, n_pad=1024):
    pts = l_shape()
    cad = pad_to(pts, n_pad)
    valid = np.arange(n_pad) < len(pts)
    Rs = np.stack([Rotation.from_rotvec(r).as_matrix() for r in rotvecs]
                  ).astype(np.float32)
    return pts, cad, valid, Rs, np.asarray(ts, np.float32)


def test_splat_depth_matches_jax_exactly():
    """Three poses of the L-shape (one partly off-image to the left),
    batched: equal z-buffers, overflow and truncation included."""
    _, cad, valid, Rs, ts = _posed_l(
        [[0.2, -0.3, 0.1], [2.5, 0.1, -0.4], [0.0, 0.3, 0.0]],
        [[2.0, -1.0, 60.0], [0.0, 3.0, 45.0], [-36.0, 0.0, 55.0]])
    out = verify_pose.splat_depth(_t(cad)[None], _t(valid)[None], _t(Rs),
                                  _t(ts), _t(K_NP)[None], 480, 640)
    for b in range(3):
        ref = jax_verify.splat_depth(jnp.asarray(cad), jnp.asarray(valid),
                                     jnp.asarray(Rs[b]), jnp.asarray(ts[b]),
                                     K_JAX, 480, 640)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))
    assert (out < verify_pose.BIGZ).sum() > 100


def test_depth_consistency_score_matches_jax():
    """The observed frame of one pose scored against it and two others
    (one flipped): rtol 1e-5 (sums over cells in another order)."""
    pts, cad, valid, Rs, ts = _posed_l(
        [[0.1, 0.2, -0.1], [0.1, 0.2, 3.0], [0.3, 0.0, -0.1]],
        [[0.0, 1.0, 55.0], [0.0, 1.0, 55.0], [0.5, 1.0, 56.0]])
    obs_z, mask = render_obs(pts @ Rs[0].T + ts[0])
    diam = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    out = verify_pose.depth_consistency_score(
        _t(cad)[None], _t(valid)[None], _t(Rs), _t(ts), _t(K_NP)[None],
        _t(obs_z)[None], _t(mask)[None], torch.tensor([diam]))
    for b in range(3):
        ref = jax_verify.depth_consistency_score(
            jnp.asarray(cad), jnp.asarray(valid), jnp.asarray(Rs[b]),
            jnp.asarray(ts[b]), K_JAX, jnp.asarray(obs_z),
            jnp.asarray(mask), diam)
        np.testing.assert_allclose(float(out[b]), float(ref), rtol=1e-5)
    assert out[0] < 0.6 * out[1]


def test_flip_hypotheses_match_jax():
    """The generic bank as a set (an eigenvector's sign may differ, which
    swaps +-90 deg): every JAX hypothesis has a port twin within 1e-5,
    translations too. A given bank: equal in order."""
    pts, cad, valid, Rs, ts = _posed_l([[0.2, -0.3, 0.1], [1.0, 2.0, 0.5]],
                                       [[2.0, -1.0, 60.0], [1.0, 0.0, 50.0]])
    out_R, out_t = multistart.flip_hypotheses(
        _t(cad)[None].expand(2, -1, -1), _t(valid)[None].expand(2, -1),
        _t(Rs), _t(ts))
    bank = symmetry.disambiguation_bank(pts, max_rots=6)
    given_R, given_t = multistart.flip_hypotheses(
        _t(cad)[None].expand(2, -1, -1), _t(valid)[None].expand(2, -1),
        _t(Rs), _t(ts), rots=_t(bank))
    assert out_R.shape == (2, 6, 3, 3)
    for b in range(2):
        args = (jnp.asarray(cad), jnp.asarray(valid), jnp.asarray(Rs[b]),
                jnp.asarray(ts[b]))
        ref_R, ref_t = (np.asarray(x) for x in
                        jax_multistart.flip_hypotheses(*args))
        for h in range(6):
            j = np.argmin(np.abs(out_R[b].numpy() - ref_R[h]).max((1, 2)))
            np.testing.assert_allclose(out_R[b, j].numpy(), ref_R[h],
                                       atol=1e-5)
            np.testing.assert_allclose(out_t[b, j].numpy(), ref_t[h],
                                       atol=1e-4)
        gR, gt = jax_multistart.flip_hypotheses(*args,
                                                rots=jnp.asarray(bank))
        np.testing.assert_allclose(given_R[b].numpy(), np.asarray(gR),
                                   atol=1e-5)
        np.testing.assert_allclose(given_t[b].numpy(), np.asarray(gt),
                                   atol=1e-4)


@pytest.mark.parametrize("bank", ["detected", "generic"])
def test_disambiguate_pose_depth_matches_jax(bank):
    """tests/test_multistart.py's L-shape and render_obs fixture, B = 2:
    frame 0 starts from a 180-degree flip of the truth and must be
    recovered (< 15 deg from the truth), frame 1 starts at the
    truth. Per frame against JAX's call: pose within 1e-3 (rad, cm) and
    the same hypothesis, by index for the object's detected bank
    (disambiguation_bank, given to both), by rotation for the generic
    bank (whose order follows eigenvector signs)."""
    pts = l_shape()
    cad = pad_to(pts, 1024)
    valid = np.arange(1024) < len(pts)
    diam = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    frames = []
    for rotvec, t in (([0.2, -0.3, 0.1], [2.0, -1.0, 60.0]),
                      ([-0.1, 0.25, 0.2], [-1.0, 1.0, 58.0])):
        R_gt = Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)
        t_gt = np.asarray(t, np.float32)
        pts_cam = pts @ R_gt.T + t_gt
        obs_z, mask = render_obs(pts_cam)
        frames.append((R_gt, t_gt, pad_to(pts_cam, 1024), obs_z, mask))
    rots = (symmetry.disambiguation_bank(pts, max_rots=6)
            if bank == "detected" else None)
    # a 180-degree flip of the truth that the bank can undo: about the
    # dominant principal axis (generic), about the bank's second
    # detected axis (detected)
    Rs, ts = jax_multistart.flip_hypotheses(
        jnp.asarray(cad), jnp.asarray(valid), jnp.asarray(frames[0][0]),
        jnp.asarray(frames[0][1]),
        rots=None if rots is None else jnp.asarray(rots))
    h = 3 if rots is None else 2
    starts = [(np.asarray(Rs[h]), np.asarray(ts[h])),
              (frames[1][0], frames[1][1])]
    assert _angle_deg(starts[0][0], frames[0][0]) > 90

    def stack(i):
        return _t(np.stack([f[i] for f in frames]))
    out = multistart.disambiguate_pose_depth(
        _t(cad)[None].expand(2, -1, -1), _t(valid)[None].expand(2, -1),
        stack(2), _t(valid)[None].expand(2, -1),
        _t(np.stack([s[0] for s in starts])),
        _t(np.stack([s[1] for s in starts])), torch.tensor([diam, diam]),
        _t(K_NP)[None].expand(2, -1, -1), stack(3), stack(4), icp_iters=10,
        sym_rots=None if rots is None else _t(rots))
    for b in range(2):
        ref = jax_multistart.disambiguate_pose_depth(
            jnp.asarray(cad), jnp.asarray(valid), jnp.asarray(frames[b][2]),
            jnp.asarray(valid), jnp.asarray(starts[b][0]),
            jnp.asarray(starts[b][1]), diam, K_JAX,
            jnp.asarray(frames[b][3]), jnp.asarray(frames[b][4]),
            icp_iters=10, sym_rots=None if rots is None
            else jnp.asarray(rots))
        assert np.degrees(1e-3) > _angle_deg(out["R"][b].numpy(),
                                           np.asarray(ref["R"]))
        np.testing.assert_allclose(out["t"][b].numpy(), np.asarray(ref["t"]),
                                   atol=1e-3)
        scores, ref_scores = (out["all_scores"][b].numpy(),
                              np.asarray(ref["all_scores"]))
        if rots is None:            # the same bank in another order
            scores, ref_scores = np.sort(scores), np.sort(ref_scores)
        else:
            assert int(out["hypothesis"][b]) == int(ref["hypothesis"])
        np.testing.assert_allclose(scores, ref_scores, rtol=1e-3)
        assert _angle_deg(out["R"][b].numpy(), frames[b][0]) < 15.0
    # the flipped start (hypothesis 0 is the start itself) was rejected
    assert int(out["hypothesis"][0]) != 0


def test_random_shape_copy_matches_jax():
    """The host copy of data/shapes.py gives the same mesh."""
    from pose6d_tpu.data.shapes import random_shape as jax_random_shape
    v, f = random_shape(5, nu=12, nv=24)
    rv, rf = jax_random_shape(5, nu=12, nv=24)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(f, rf)
