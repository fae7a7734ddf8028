"""skix_torch geometry and solvers against skix, float32 on the CPU:
rotations, DLT triangulation, the BA losses and LM bundle adjustment on
``tests/test_ba.py``-style problems."""

import numpy as np
import torch

import jax.numpy as jnp

from skix.geometry import rotations as srot
from skix.geometry import triangulate as stri
from skix.solvers import BAConfig as SkixBAConfig
from skix.solvers import ba_loss_terms as skix_ba_loss_terms
from skix.solvers import bundle_adjust as skix_bundle_adjust
from skix.solvers.ba import project_tcj as skix_project_tcj
from skix_torch.geometry import rotations as trot
from skix_torch.geometry import triangulate as ttri
from skix_torch.solvers import BAConfig, ba_loss_terms, bundle_adjust
from skix_torch.solvers.ba import camera_centers, project_tcj
from skix_torch.solvers.lm import levenberg_marquardt

rng = np.random.default_rng(17)
K = np.array([[1100.0, 0, 960], [0, 1100.0, 540], [0, 0, 1]], np.float32)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _rig():
    R = np.stack([np.eye(3), np.asarray(srot.rotvec_to_matrix(
        jnp.asarray([0.05, 0.5, 0.02])))]).astype(np.float32)
    t = np.array([[0.0, 0, 0], [-15.0, 0.3, 2.0]], np.float32)
    return R, t


def _problem(T=8, J=17, seed=5):
    """A smooth skeleton trajectory 20 units in front of a two-camera rig
    and its exact projections (the ``tests/test_ba.py`` problem)."""
    r = np.random.default_rng(seed)
    R, t = _rig()
    X = (r.normal(size=(1, J, 3)) * 0.4
         + np.linspace(0, 1, T)[:, None, None] * np.array([2.0, 0.1, 0.5])
         + np.array([0, 0, 20.0])).astype(np.float32)
    obs = np.asarray(skix_project_tcj(jnp.asarray(X), jnp.asarray(R),
                                      jnp.asarray(t), jnp.asarray(K)))
    return R, t, X, obs


# --------------------------------------------------------------------------
# rotations
# --------------------------------------------------------------------------
def _rotvecs():
    rv = rng.normal(size=(16, 3))
    near_pi = rv[:4] / np.linalg.norm(rv[:4], axis=-1, keepdims=True) * 3.1
    tiny = rv[:4] * 1e-6
    return np.concatenate([rv, near_pi, tiny, np.zeros((1, 3))]).astype(np.float32)


def test_rotvec_exp_and_log_match_skix():
    rv = _rotvecs()
    R = trot.rotvec_to_matrix(_t(rv))
    np.testing.assert_allclose(R.numpy(), np.asarray(srot.rotvec_to_matrix(
        jnp.asarray(rv))), atol=1e-5)
    np.testing.assert_allclose(trot.matrix_to_rotvec(R).numpy(),
                               np.asarray(srot.matrix_to_rotvec(jnp.asarray(
                                   R.numpy()))), atol=1e-5)


def test_quaternions_match_skix():
    R = trot.rotvec_to_matrix(_t(_rotvecs()))
    q = trot.matrix_to_quat(R)
    np.testing.assert_allclose(q.numpy(), np.asarray(srot.matrix_to_quat(
        jnp.asarray(R.numpy()))), atol=1e-5)
    qn = rng.normal(size=(8, 4)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    np.testing.assert_allclose(trot.quat_to_matrix(_t(qn)).numpy(),
                               np.asarray(srot.quat_to_matrix(jnp.asarray(qn))),
                               atol=1e-6)
    np.testing.assert_allclose(trot.quat_to_matrix(q).numpy(), R.numpy(),
                               atol=1e-5)


def test_rotvec_jacobian_finite_at_zero():
    jac = torch.func.jacrev(trot.rotvec_to_matrix)(torch.zeros(3))
    assert torch.isfinite(jac).all()
    jac = torch.func.jacfwd(trot.matrix_to_rotvec)(torch.eye(3))
    assert torch.isfinite(jac).all()


# --------------------------------------------------------------------------
# triangulation
# --------------------------------------------------------------------------
def test_triangulate_sequence_matches_skix():
    R, t = _rig()
    Xw = (rng.normal(size=(6, 17, 3)) * 0.5 + np.array([0, 0, 20.0])).astype(np.float32)
    uv = np.asarray(skix_project_tcj(jnp.asarray(Xw), jnp.asarray(R),
                                     jnp.asarray(t), jnp.asarray(K)))
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=uv.shape[:-1]).astype(np.float32)
    K_b = K * np.array([[1.1], [1.1], [1.0]], np.float32)
    want = np.asarray(stri.triangulate_sequence(
        jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]), jnp.asarray(K),
        jnp.asarray(R[1]), jnp.asarray(t[1]), w_a=jnp.asarray(w[:, 0]),
        w_b=jnp.asarray(w[:, 1]), K_b=jnp.asarray(K_b)))
    got = ttri.triangulate_sequence(_t(uv[:, 0]), _t(uv[:, 1]), _t(K),
                                    _t(R[1]), _t(t[1]), w_a=_t(w[:, 0]),
                                    w_b=_t(w[:, 1]), K_b=_t(K_b)).numpy()
    # two f32 eigensolvers on a 4×4 normal matrix with entries ~1e6
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_triangulate_dlt_weighted_view_dropout():
    """Three views, the third corrupted but weighted 0: exact recovery."""
    R, t = _rig()
    R3 = np.asarray(srot.rotvec_to_matrix(jnp.asarray([0.0, -0.3, 0.0])))
    Rs = np.concatenate([R, R3[None]]).astype(np.float32)
    ts = np.concatenate([t, [[3.0, 0.0, 0.2]]]).astype(np.float32)
    Xw = (rng.normal(size=(5, 3)) + np.array([0, 0, 10.0])).astype(np.float32)
    uv = np.asarray(skix_project_tcj(jnp.asarray(Xw[None]), jnp.asarray(Rs),
                                     jnp.asarray(ts), jnp.asarray(K)))[0]
    uv = uv.transpose(1, 0, 2).copy()
    uv[:, 2] += 300.0
    P = ttri.projection_matrix(_t(K), _t(Rs), _t(ts))
    w = np.tile(np.array([1.0, 1.0, 0.0], np.float32), (5, 1))
    got = ttri.triangulate_dlt(_t(uv), P, _t(w)).numpy()
    want = np.asarray(stri.triangulate_dlt(jnp.asarray(uv), jnp.asarray(P.numpy()),
                                           jnp.asarray(w)))
    np.testing.assert_allclose(got, Xw, atol=1e-2)
    np.testing.assert_allclose(got, want, atol=1e-3)


# --------------------------------------------------------------------------
# BA losses and LM
# --------------------------------------------------------------------------
def test_projection_and_loss_terms_match_skix():
    R, t, X, obs = _problem(T=6)
    obs = (obs + rng.normal(size=obs.shape) * 2.0).astype(np.float32)
    conf = rng.random(obs.shape[:-1]).astype(np.float32)
    Ks = np.broadcast_to(K, (2, 3, 3))
    np.testing.assert_allclose(
        project_tcj(_t(X), _t(R), _t(t), _t(Ks)).numpy(),
        np.asarray(skix_project_tcj(jnp.asarray(X), jnp.asarray(R),
                                    jnp.asarray(t), jnp.asarray(Ks))),
        rtol=1e-6, atol=1e-3)
    rv = srot.matrix_to_rotvec(jnp.asarray(R))
    want = skix_ba_loss_terms(jnp.asarray(X), rv, jnp.asarray(t),
                              jnp.asarray(Ks), jnp.asarray(obs),
                              jnp.asarray(conf), SkixBAConfig())
    got = ba_loss_terms(_t(X), _t(np.asarray(rv)), _t(t), _t(Ks), _t(obs),
                        _t(conf), BAConfig())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    C = camera_centers(_t(R), _t(t)).numpy()
    np.testing.assert_allclose(np.einsum("cij,cj->ci", R, C) + t, 0, atol=1e-5)


def test_lm_linear_least_squares():
    A = rng.normal(size=(12, 6)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    At, bt = _t(A), _t(b)
    res = levenberg_marquardt(lambda x: At @ x - bt, torch.zeros(6))
    x_star = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(res.x.numpy(), x_star, atol=1e-4)
    assert float(res.cost) < float(res.initial_cost)


def test_bundle_adjust_pose_only_matches_skix():
    """Joints only: a convex-enough problem whose converged joints agree
    although the LM probe draws differ."""
    R, t, X, obs = _problem()
    Xn = (X + rng.normal(size=X.shape) * 0.08).astype(np.float32)
    Ks = np.broadcast_to(K, (2, 3, 3))
    kw = dict(mode="pose_only", method="lm", max_steps=40, w_temporal=1e-4,
              w_bone=1e-4)
    want = skix_bundle_adjust(Xn, R, t, Ks, obs, cfg=SkixBAConfig(**kw))
    got = bundle_adjust(_t(Xn), _t(R), _t(t), _t(Ks), _t(obs),
                        cfg=BAConfig(**kw))
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    assert float(got.final_cost) < 1e-4 * float(got.initial_cost)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=1e-4)
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(want.R))
    np.testing.assert_allclose(got.t.numpy(), t)


def test_bundle_adjust_full_matches_skix():
    """Joints, rotations and translations: the gauge is free, so X, R and t
    may settle apart; the fit (cost, reprojections) is what must agree."""
    R, t, X, obs = _problem()
    noise = np.array([[0.0, 0, 0], [0.01, -0.02, 0.01]], np.float32)
    R_noisy = np.asarray(srot.rotvec_to_matrix(jnp.asarray(noise))) @ R
    t_noisy = t + np.array([[0.0, 0, 0], [0.3, -0.2, 0.4]], np.float32)
    Ks = np.broadcast_to(K, (2, 3, 3))
    kw = dict(mode="full", method="lm", max_steps=60, w_temporal=1e-5,
              w_bone=1e-5, w_baseline=0.0)
    want = skix_bundle_adjust(X, R_noisy, t_noisy, Ks, obs, cfg=SkixBAConfig(**kw))
    got = bundle_adjust(_t(X), _t(R_noisy), _t(t_noisy), _t(Ks), _t(obs),
                        cfg=BAConfig(**kw))
    init = float(want.initial_cost)
    np.testing.assert_allclose(float(got.initial_cost), init, rtol=1e-5)
    assert float(got.losses["reprojection"]) < 1.0
    assert abs(float(got.final_cost) - float(want.final_cost)) < 1e-6 * init
    px = project_tcj(got.X, got.R, got.t, _t(Ks)).numpy()
    np.testing.assert_allclose(px, np.asarray(skix_project_tcj(
        want.X, want.R, want.t, jnp.asarray(Ks))), atol=0.05)


def test_bundle_adjust_adam_matches_skix():
    """``method="adam"`` (optax's Adam, written out) on the same noisy
    problem: no random draws, so the port follows skix step by step."""
    R, t, X, obs = _problem(T=4)
    Xn = X + np.random.default_rng(3).normal(size=X.shape).astype(
        np.float32) * 0.05
    kw = dict(mode="pose_cam_t", method="adam", adam_iters=60, adam_lr=1e-2)
    want = skix_bundle_adjust(Xn, R, t, K, obs, cfg=SkixBAConfig(**kw))
    got = bundle_adjust(_t(Xn), _t(R), _t(t), _t(K), _t(obs),
                        cfg=BAConfig(**kw))
    assert got.iterations == 60
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    assert float(got.final_cost) < 0.5 * float(got.initial_cost)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    init = float(want.initial_cost)
    for k, v in want.losses.items():   # each term within 1e-5 of the cost
        assert abs(float(got.losses[k]) - float(v)) < 1e-5 * init, k
