"""skix_torch's metrics, fusion and biomechanics against skix, float32 on
the CPU: the MPJPE family and the sequence reports, the fusion
confidences, the raw (MHR-70) and no-extrinsics (H36M) fusion routes and
the joint-angle, tilt and heading series with the turn segmentation, one
case per function on the same seeded inputs (limit 1e-4; angles in
degrees 1e-3; turn segments equal)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.angle import biomech as sbio
from skix.fuse import confidence as sconf
from skix.fuse import fuse as sfuse
from skix.geometry.rotations import rotvec_to_matrix
from skix.geometry.skeletons import (H36M_BONES, H36M_SYMMETRIC_BONES,
                                     MHR70_BODY_EDGES, MHR70_SYMMETRIC_BONES)
from skix.metrics import evaluation as seval
from skix.metrics import losses as sloss
from skix.pipelines.fuse import MHR70_CANON
from skix_torch.angle import biomech as tbio
from skix_torch.fuse import confidence as tconf
from skix_torch.fuse import fuse as tfuse
from skix_torch.metrics import evaluation as teval
from skix_torch.metrics import losses as tloss


def _x(r, *shape, scale=1.0):
    return (r.normal(size=shape) * scale).astype(np.float32)


def _two_views(r, T=30, J=70, nan_frac=0.0):
    """A moving MHR-70-sized pose, a noisy left view and a right view in a
    rotated, shifted frame; ``nan_frac`` of the joints missing (NaN)."""
    gt = _x(r, 1, J, 3, scale=0.3) + _x(r, T, J, 3, scale=0.01).cumsum(0)
    R = np.asarray(rotvec_to_matrix(jnp.float32([0.1, 0.4, -0.05])))
    left = gt + _x(r, T, J, 3, scale=0.02)
    right = gt @ R.T + np.float32([0.5, -0.2, 1.0]) + _x(r, T, J, 3, scale=0.02)
    for v in (left, right):
        v[r.random((T, J)) < nan_frac] = np.nan
    return gt, left.astype(np.float32), right.astype(np.float32)


def _h36m(r, T=20):
    base = _x(r, 1, 17, 3, scale=0.3) + _x(r, T, 17, 3, scale=0.01).cumsum(0)
    R = np.asarray(rotvec_to_matrix(jnp.float32([0.05, -0.3, 0.02])))
    return (base + _x(r, T, 17, 3, scale=0.02),
            (base @ R.T) * 1.2 + 0.4 + _x(r, T, 17, 3, scale=0.02))


def _mask(r, shape, p=0.85):
    return r.random(shape) < p


EYE15 = list(sbio.TARGET_IDS)

CASES = [
    ("mpjpe", sloss.mpjpe, tloss.mpjpe,
     lambda r: (_x(r, 5, 17, 3), _x(r, 5, 17, 3))),
    ("mpjpe_valid", sloss.mpjpe, tloss.mpjpe,
     lambda r: (_x(r, 5, 17, 3), _x(r, 5, 17, 3), _mask(r, (5, 17)))),
    ("weighted_mpjpe", sloss.weighted_mpjpe, tloss.weighted_mpjpe,
     lambda r: (_x(r, 5, 17, 3), _x(r, 5, 17, 3),
                r.random(17).astype(np.float32))),
    ("p_mpjpe", sloss.p_mpjpe, tloss.p_mpjpe,
     lambda r: (_x(r, 6, 17, 3), _x(r, 6, 17, 3))),
    ("n_mpjpe", sloss.n_mpjpe, tloss.n_mpjpe,
     lambda r: (_x(r, 6, 17, 3), _x(r, 6, 17, 3))),
    ("mean_velocity_error", sloss.mean_velocity_error,
     tloss.mean_velocity_error, lambda r: (_x(r, 9, 17, 3), _x(r, 9, 17, 3))),
    ("per_joint_error", sloss.per_joint_error, tloss.per_joint_error,
     lambda r: (_x(r, 4, 17, 3), _x(r, 4, 17, 3))),
    ("temporal_metrics", seval.temporal_metrics, teval.temporal_metrics,
     lambda r: (_x(r, 20, 17, 3),)),
    ("temporal_metrics_valid", seval.temporal_metrics,
     teval.temporal_metrics, lambda r: (_x(r, 20, 17, 3), _mask(r, (20, 17)))),
    ("bone_length_cv", lambda X, v: seval.bone_length_cv(X, H36M_BONES, v),
     lambda X, v: teval.bone_length_cv(X, H36M_BONES, v),
     lambda r: (_x(r, 20, 17, 3), _mask(r, (20, 17)))),
    ("bone_length_cv_all", lambda X: seval.bone_length_cv(X, MHR70_BODY_EDGES),
     lambda X: teval.bone_length_cv(X, MHR70_BODY_EDGES),
     lambda r: (_x(r, 20, 70, 3),)),
    ("symmetry_error",
     lambda X: seval.symmetry_error(X, MHR70_SYMMETRIC_BONES),
     lambda X: teval.symmetry_error(X, MHR70_SYMMETRIC_BONES),
     lambda r: (_x(r, 20, 70, 3),)),
    ("eval_fused_sequence",
     lambda f, a, b: seval.eval_fused_sequence(f, a, b, H36M_BONES,
                                               H36M_SYMMETRIC_BONES),
     lambda f, a, b: teval.eval_fused_sequence(f, a, b, H36M_BONES,
                                               H36M_SYMMETRIC_BONES),
     lambda r: (_x(r, 12, 17, 3), _x(r, 12, 17, 3), _x(r, 12, 17, 3))),
    ("fit_weak_perspective", sconf.fit_weak_perspective,
     lambda X, U, w: tconf.fit_weak_perspective(X, U, w),
     lambda r: (_x(r, 17, 3), _x(r, 17, 2, scale=100),
                r.random(17).astype(np.float32))),
    ("weakpersp_reproj_confidence",
     lambda X, U, v: sconf.weakpersp_reproj_confidence(X, U, v, 12.0),
     lambda X, U, v: tconf.weakpersp_reproj_confidence(X, U, v, 12.0),
     lambda r: (_x(r, 10, 70, 3, scale=0.4), _x(r, 10, 70, 2, scale=120)
                + 500, _mask(r, (10, 70)))),
    ("canonicalize_pose_3d",
     lambda X: sconf.canonicalize_pose_3d(X, **MHR70_CANON),
     lambda X: tconf.canonicalize_pose_3d(X, **MHR70_CANON),
     lambda r: (_x(r, 8, 70, 3),)),
    ("crossview_consistency_confidence",
     lambda a, b: sconf.crossview_consistency_confidence(a, b, **MHR70_CANON),
     lambda a, b: tconf.crossview_consistency_confidence(a, b, **MHR70_CANON),
     lambda r: _two_views(r, T=10, nan_frac=0.05)[1:]),
    ("softmax2", sfuse.softmax2, tfuse.softmax2,
     lambda r: (_x(r, 6, 17), _x(r, 6, 17))),
    ("median_bone_lengths",
     lambda X, v: sfuse.median_bone_lengths(X, MHR70_BODY_EDGES, v),
     lambda X, v: tfuse.median_bone_lengths(X, MHR70_BODY_EDGES, v),
     lambda r: (_x(r, 15, 70, 3), _mask(r, (15, 70), 0.6))),
    ("q_from_bone_deviation",
     lambda X, m: sfuse.q_from_bone_deviation(X, MHR70_BODY_EDGES, m),
     lambda X, m: tfuse.q_from_bone_deviation(X, MHR70_BODY_EDGES, m),
     lambda r: (_two_views(r, T=6, nan_frac=0.1)[1],
                r.random(len(MHR70_BODY_EDGES)).astype(np.float32))),
    ("q_from_temporal", sfuse.q_from_temporal, tfuse.q_from_temporal,
     lambda r: _two_views(r, T=6, nan_frac=0.1)[1:]),
    ("q_2d_sanity", lambda U: sfuse.q_2d_sanity(U, 640, 480),
     lambda U: tfuse.q_2d_sanity(U, 640, 480),
     lambda r: (_x(r, 6, 17, 2, scale=400) + 300,)),
    ("combine_q", sfuse.combine_q, tfuse.combine_q,
     lambda r: (_x(r, 6, 17), _x(r, 6, 17), _x(r, 6, 17))),
    ("body_side_bias", sfuse.body_side_bias, tfuse.body_side_bias,
     lambda r: (_mask(r, (17,), 0.3), _mask(r, (17,), 0.3))),
    ("align_right_to_left", sfuse.align_right_to_left,
     tfuse.align_right_to_left, lambda r: _two_views(r, nan_frac=0.05)[1:]),
    ("fuse_two_views", sfuse.fuse_two_views, tfuse.fuse_two_views,
     lambda r: (*_two_views(r, T=8, nan_frac=0.1)[1:], _x(r, 8, 70),
                _x(r, 8, 70))),
    ("fuse_sequence",
     lambda a, b, cl, cr: sfuse.fuse_sequence(a, b, cl, cr),
     lambda a, b, cl, cr: tfuse.fuse_sequence(a, b, cl, cr),
     lambda r: (*_two_views(r, nan_frac=0.05)[1:],
                r.random((30, 70)).astype(np.float32),
                r.random((30, 70)).astype(np.float32))),
    ("center_scale_h36m", sfuse.center_scale_h36m, tfuse.center_scale_h36m,
     lambda r: (_x(r, 6, 17, 3),)),
    ("fuse_pose_no_extrinsics",
     lambda a, b: sfuse.fuse_pose_no_extrinsics(a, b, tau=0.08),
     lambda a, b: tfuse.fuse_pose_no_extrinsics(a, b, tau=0.08), _h36m),
    ("fuse_pose_no_extrinsics_weighted",
     lambda a, b, wl, wr: sfuse.fuse_pose_no_extrinsics(
         a, b, tau=0.05, allow_scale=True, wL=wl, wR=wr),
     lambda a, b, wl, wr: tfuse.fuse_pose_no_extrinsics(
         a, b, tau=0.05, allow_scale=True, wL=wl, wR=wr),
     lambda r: (*_h36m(r), r.random((20, 17)).astype(np.float32),
                r.random((20, 17)).astype(np.float32))),
]


def _leaves(x):
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name,sfn,tfn,make", CASES, ids=[c[0] for c in CASES])
def test_function_matches_skix(name, sfn, tfn, make):
    args = make(np.random.default_rng(sum(map(ord, name))))
    want = _leaves(jit0(sfn)(*[jnp.asarray(a) for a in args]))
    got = _leaves(tfn(*[torch.tensor(a) for a in args]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5)


def test_before_after_fusion_report_matches_skix():
    r = np.random.default_rng(4)
    gt, left, right = _two_views(r)
    fused = 0.5 * (left + gt)
    args = dict(left=left, right=gt + 0.03, fused=fused, smoothed=fused * 0.99)
    want = seval.before_after_fusion_report(
        jnp.asarray(gt), **{k: jnp.asarray(v) for k, v in args.items()})
    got = teval.before_after_fusion_report(
        torch.tensor(gt), **{k: torch.tensor(v) for k, v in args.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def _skier(r, T=120, J=70):
    """A full MHR-70 skier turning through ±60 degrees of heading with
    bending knees and a few missing joints."""
    head = np.radians(60 * np.sin(np.linspace(0, 3 * np.pi, T)))
    base = _x(r, J, 3, scale=0.3)
    base[9], base[10] = [-0.15, 0, 0], [0.15, 0, 0]        # hips
    base[5], base[6] = [-0.2, 0.5, 0], [0.2, 0.5, 0]       # shoulders
    base[11], base[12] = [-0.15, -0.45, 0.1], [0.15, -0.45, 0.1]  # knees
    c, s = np.cos(head), np.sin(head)
    Ry = np.stack([np.stack([c, 0 * c, s], -1), np.stack([0 * c, 1 + 0 * c, 0 * c], -1),
                   np.stack([-s, 0 * c, c], -1)], -2)
    X = np.einsum("tij,nj->tni", Ry, base) + _x(r, T, J, 3, scale=0.005)
    X[r.random((T, J)) < 0.02] = np.nan
    return X.astype(np.float32)


@pytest.mark.parametrize("layout", ["mhr70", "subset15"])
def test_biomech_series_and_turns_match_skix(layout):
    r = np.random.default_rng(12)
    X = _skier(r)
    if layout == "subset15":
        X = X[:, EYE15]
    want_s, want_t = sbio.compute_all_series(X)
    got_s, got_t = tbio.compute_all_series(torch.tensor(X))
    assert list(got_s) == list(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-3,
                                   equal_nan=True, err_msg=k)
    assert got_t == want_t and len(got_t) >= 2
    up = (0.0, -1.0, 0.0)
    for name in ("compute_tilt_angles", "compute_facing_heading"):
        w = getattr(sbio, name)(jnp.asarray(X), up, tbio.mapping_for(X.shape[1]))
        g = getattr(tbio, name)(torch.tensor(X), up, tbio.mapping_for(X.shape[1]))
        for a, b in zip(_leaves(g), _leaves(w)):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-3, equal_nan=True)
