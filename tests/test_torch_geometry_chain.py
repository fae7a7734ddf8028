"""skix_torch geometry of the run_all chain against skix, float32 on the CPU:
the rest of rotations, skeletons, camera, triangulate, smoothing and rigid,
one case per function on the same seeded inputs (limit 1e-4 unless a case
says otherwise)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.geometry import camera as scam
from skix.geometry import rigid as srig
from skix.geometry import rotations as srot
from skix.geometry import skeletons as sske
from skix.geometry import smoothing as ssmo
from skix.geometry import triangulate as stri
from skix_torch.geometry import camera as tcam
from skix_torch.geometry import rigid as trig
from skix_torch.geometry import rotations as trot
from skix_torch.geometry import skeletons as tske
from skix_torch.geometry import smoothing as tsmo
from skix_torch.geometry import triangulate as ttri

K = np.array([[1100.0, 0, 960], [0, 1100.0, 540], [0, 0, 1]], np.float32)
DIST = np.array([0.05, -0.02, 0.001, -0.002, 0.01, 0.02, -0.01, 0.005,
                 0.001, -0.001, 0.0005, 0.0002], np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _quats(r, n=8):
    q = r.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rot(r, n=6):
    return np.asarray(srot.rotvec_to_matrix(jnp.asarray(
        r.normal(size=(n, 3)).astype(np.float32))))


def _valid(r, shape, p=0.8):
    v = r.random(shape) < p
    v[0] = True
    return v


def _x(r, *shape, scale=1.0):
    return (r.normal(size=shape) * scale).astype(np.float32)


R_RIG = np.asarray(srot.rotvec_to_matrix(jnp.float32([0.02, 0.3, 0.01])))
T_RIG = np.float32([-5.0, 0.1, 0.3])


def _stereo(r, T=5):
    """Distorted two-view pixels of a skeleton 12 units in front of the rig,
    with half-pixel noise, the rig and confidences in [0.2, 1] (the data of
    ``test_torch_geometry_solvers.py``'s DLT case)."""
    X = _x(r, T, 17, 3) + np.float32([0, 0, 12])
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    a = np.asarray(scam.project_points(X, K, eye, zero, DIST))
    b = np.asarray(scam.project_points(X, K, R_RIG, T_RIG, DIST))
    return (a + _x(r, *a.shape, scale=0.5), b + _x(r, *b.shape, scale=0.5),
            R_RIG, T_RIG, r.uniform(0.2, 1.0, (T, 17)).astype(np.float32),
            r.uniform(0.2, 1.0, (T, 17)).astype(np.float32))


# (name, skix function, port function, inputs from an rng, atol); inputs are
# numpy arrays (passed as tensors / jnp arrays) or other values as they are
CASES = [
    ("qrot", srot.qrot, trot.qrot, lambda r: (_quats(r), _x(r, 8, 3)), 1e-5),
    ("qinverse", srot.qinverse, trot.qinverse, lambda r: (_quats(r),), 0),
    ("qmul", srot.qmul, trot.qmul, lambda r: (_quats(r), _quats(r)), 1e-6),
    ("rot6d_to_matrix", srot.rot6d_to_matrix, trot.rot6d_to_matrix,
     lambda r: (_x(r, 5, 6),), 1e-5),
    ("matrix_to_rot6d", srot.matrix_to_rot6d, trot.matrix_to_rot6d,
     lambda r: (_rot(r),), 0),
    ("coco_to_h36m", sske.coco_to_h36m, tske.coco_to_h36m,
     lambda r: (_x(r, 4, 17, 2, scale=100),), 1e-4),
    ("coco_to_h36m_nohead", lambda x: sske.coco_to_h36m(x, False),
     lambda x: tske.coco_to_h36m(x, False),
     lambda r: (_x(r, 4, 17, 3),), 0),
    ("h36m_to_coco", sske.h36m_to_coco, tske.h36m_to_coco,
     lambda r: (_x(r, 4, 17, 3),), 1e-6),
    ("coco_scores_to_h36m", sske.coco_scores_to_h36m,
     tske.coco_scores_to_h36m, lambda r: (r.random((5, 17)).astype(np.float32),),
     0),
    ("bone_lengths", lambda x: sske.bone_lengths(x, sske.H36M_BONES),
     lambda x: tske.bone_lengths(x, tske.H36M_BONES),
     lambda r: (_x(r, 3, 17, 3),), 1e-6),
    ("flip_keypoints",
     lambda x: sske.flip_keypoints(x, sske.H36M_LEFT, sske.H36M_RIGHT),
     lambda x: tske.flip_keypoints(x, tske.H36M_LEFT, tske.H36M_RIGHT),
     lambda r: (_x(r, 2, 6, 17, 2),), 0),
    ("normalize_screen_coordinates",
     lambda x: scam.normalize_screen_coordinates(x, 1920, 1080),
     lambda x: tcam.normalize_screen_coordinates(x, 1920, 1080),
     lambda r: (_x(r, 6, 17, 2, scale=800),), 1e-6),
    ("image_coordinates", lambda x: scam.image_coordinates(x, 1920, 1080),
     lambda x: tcam.image_coordinates(x, 1920, 1080),
     lambda r: (_x(r, 6, 17, 2),), 1e-4),
    ("world_to_camera", scam.world_to_camera, tcam.world_to_camera,
     lambda r: (_x(r, 10, 3), _quats(r, 1)[0], _x(r, 3)), 1e-5),
    ("camera_to_world", scam.camera_to_world, tcam.camera_to_world,
     lambda r: (_x(r, 10, 3), _quats(r, 1)[0], _x(r, 3)), 1e-5),
    ("project_to_2d_h36m", scam.project_to_2d_h36m, tcam.project_to_2d_h36m,
     lambda r: (_x(r, 4, 17, 3) * 0.3 + np.float32([0, 0, 5]),
                np.concatenate([[1100, 1100, 960, 540], _x(r, 5, scale=0.01)]
                               ).astype(np.float32)), 1e-3),
    ("project_linear", scam.project_linear, tcam.project_linear,
     lambda r: (_x(r, 4, 17, 3) * 0.3 + np.float32([0, 0, 5]),
                np.float32([1100, 1100, 960, 540])), 1e-3),
    ("distort_rational", scam.distort_rational, tcam.distort_rational,
     lambda r: (_x(r, 20, 2, scale=0.4), DIST), 1e-6),
    ("distort_rational_k5", scam.distort_rational, tcam.distort_rational,
     lambda r: (_x(r, 20, 2, scale=0.4), DIST[:5]), 1e-6),
    ("project_points", lambda X, R, t: scam.project_points(X, K, R, t, DIST),
     lambda X, R, t: tcam.project_points(X, torch.tensor(K), R, t, DIST),
     lambda r: (_x(r, 30, 3) + np.float32([0, 0, 12]), _rot(r, 1)[0],
                _x(r, 3)), 1e-2),
    ("project_points_batched_K",
     lambda X, R, t, Kb: scam.project_points(X, Kb, R, t),
     lambda X, R, t, Kb: tcam.project_points(X, Kb, R, t),
     lambda r: (_x(r, 4, 30, 3) + np.float32([0, 0, 12]), _rot(r, 1)[0],
                _x(r, 3), np.broadcast_to(K, (4, 3, 3)).copy()), 1e-2),
    ("camera_center", scam.camera_center, tcam.camera_center,
     lambda r: (_rot(r), _x(r, 6, 3)), 1e-5),
    ("reprojection_error",
     lambda X, uv, R, t, v: scam.reprojection_error(X, uv, K, R, t, DIST, v),
     lambda X, uv, R, t, v: tcam.reprojection_error(X, uv, torch.tensor(K),
                                                    R, t, DIST, v),
     lambda r: (_x(r, 30, 3) + np.float32([0, 0, 12]),
                _x(r, 30, 2, scale=50) + np.float32([960, 540]),
                _rot(r, 1)[0], _x(r, 3), _valid(r, (30,))), 1e-2),
    ("undistort_points",
     lambda uv: stri.undistort_points(uv, K, DIST),
     lambda uv: ttri.undistort_points(uv, torch.tensor(K), DIST),
     lambda r: (_x(r, 8, 17, 2, scale=300) + np.float32([960, 540]),), 1e-2),
    ("positive_depth_mask", stri.positive_depth_mask, ttri.positive_depth_mask,
     lambda r: (_x(r, 6, 17, 3, scale=5), _rot(r, 1)[0], _x(r, 3)), 0),
    ("triangulate_sequence_dist",
     lambda a, b, R, t, wa, wb: stri.triangulate_sequence(
         a, b, K, R, t, w_a=wa, w_b=wb, dist=DIST),
     lambda a, b, R, t, wa, wb: ttri.triangulate_sequence(
         a, b, torch.tensor(K), R, t, w_a=wa, w_b=wb, dist=DIST),
     # two f32 eigensolvers on a 4×4 normal matrix with entries ~1e6: the
     # DLT case's limit in test_torch_geometry_solvers.py
     lambda r: _stereo(r), 1e-3),
    ("ema", lambda x, v: ssmo.ema(x, 0.6, v), lambda x, v: tsmo.ema(x, 0.6, v),
     lambda r: (_x(r, 30, 5, 3), _valid(r, (30, 5, 3))), 1e-5),
    ("adaptive_ema", lambda x, v: ssmo.adaptive_ema(x, valid=v),
     lambda x, v: tsmo.adaptive_ema(x, valid=v),
     lambda r: (_x(r, 40, 17, 3, scale=0.3), _valid(r, (40, 17), 0.7)), 1e-5),
    ("adaptive_ema_alpha_joint",
     lambda x, a: ssmo.adaptive_ema(x, alpha_joint=a, speed_gain=0.5),
     lambda x, a: tsmo.adaptive_ema(x, alpha_joint=a, speed_gain=0.5),
     lambda r: (_x(r, 25, 17, 3), r.uniform(0.3, 1.0, 17).astype(np.float32)),
     1e-5),
    ("savgol_smooth", lambda x: ssmo.savgol_smooth(x, 11, 3),
     lambda x: tsmo.savgol_smooth(x, 11, 3),
     lambda r: (_x(r, 40, 17, 3),), 1e-5),
    ("savgol_smooth_short", lambda x: ssmo.savgol_smooth(x, 11, 3),
     lambda x: tsmo.savgol_smooth(x, 11, 3), lambda r: (_x(r, 9, 17, 3),), 0),
    ("moving_average", lambda x: ssmo.moving_average(x, 5),
     lambda x: tsmo.moving_average(x, 5), lambda r: (_x(r, 30, 4),), 1e-5),
    ("velocity", ssmo.velocity, tsmo.velocity, lambda r: (_x(r, 12, 17, 3),),
     0),
    ("jerk_metric", ssmo.jerk_metric, tsmo.jerk_metric,
     lambda r: (_x(r, 12, 17, 3),), 1e-5),
    ("procrustes_align", srig.procrustes_align, trig.procrustes_align,
     lambda r: (_x(r, 17, 3), _x(r, 17, 3)), 1e-5),
]


def _to_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_torch(a):
    return torch.tensor(a) if isinstance(a, np.ndarray) else a


def _leaves(x):
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, tuple):
        return list(x)
    return [x]


@pytest.mark.parametrize("name,sfn,tfn,make,atol", CASES,
                         ids=[c[0] for c in CASES])
def test_function_matches_skix(name, sfn, tfn, make, atol):
    args = make(_rng(sum(map(ord, name))))
    want = _leaves(jit0(sfn)(*[_to_jax(a) for a in args]))
    got = _leaves(tfn(*[_to_torch(a) for a in args]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("allow_scale", [False, True])
def test_umeyama_batched_matches_skix_per_frame(allow_scale):
    """One batched solve over frames equals skix's per-frame solves, with
    validity weights (0 drops a joint)."""
    r = _rng(3)
    y = _x(r, 6, 17, 3)
    R = _rot(r)
    x = (np.einsum("tij,tnj->tni", R, y) * 1.3 + _x(r, 6, 1, 3)
         + _x(r, 6, 17, 3, scale=0.01)).astype(np.float32)
    w = _valid(r, (6, 17)).astype(np.float32)
    got = trig.umeyama(torch.tensor(x), torch.tensor(y), torch.tensor(w),
                       allow_scale=allow_scale)
    for i in range(6):
        want = srig.umeyama(jnp.asarray(x[i]), jnp.asarray(y[i]),
                            jnp.asarray(w[i]), allow_scale=allow_scale)
        np.testing.assert_allclose(got.R[i].numpy(), np.asarray(want.R),
                                   atol=1e-5)
        np.testing.assert_allclose(got.t[i].numpy(), np.asarray(want.t),
                                   atol=1e-4)
        np.testing.assert_allclose(float(got.s[i]), float(want.s), rtol=1e-5)
        rep_t = trig.rigid_validity(
            trig.RigidTransform(got.s[i], got.R[i], got.t[i]),
            torch.tensor(x[i]), torch.tensor(y[i]), torch.tensor(w[i]))
        rep_s = srig.rigid_validity(want, jnp.asarray(x[i]), jnp.asarray(y[i]),
                                    jnp.asarray(w[i]))
        for k in rep_s:
            np.testing.assert_allclose(float(rep_t[k]), float(rep_s[k]),
                                       atol=1e-4)
    k = trig.kabsch(torch.tensor(x[0]), torch.tensor(y[0]))
    np.testing.assert_allclose(k.R.numpy(), np.asarray(
        srig.kabsch(jnp.asarray(x[0]), jnp.asarray(y[0])).R), atol=1e-5)
