"""skix_torch's MHR rig and parameter conversions against skix's, on the CPU.

Inputs come from numpy seeds; skix's functions run jitted (compiled once for
the file) and the port's eagerly on the same arrays. Tolerance 1e-5 (float32
trigonometry in another library), relative to the largest element where
that exceeds 1: the rig's joints are in cm, up to ~200, where one float32
step is 1.5e-5, and FK sums products along chains of up to 9 joints.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.models import mhr as S
from skix_torch.models import mhr as P

rng = np.random.default_rng(808)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want, **tol):
    want = np.asarray(want, np.float32)
    tol = tol or dict(rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, **tol)


def _gimbal_matrices():
    """Rotation matrices at and near the XYZ gimbal lock (y = ±π/2), and
    random ones: the port must take skix's branch on the same input."""
    eul = rng.uniform(-np.pi, np.pi, (12, 3))
    eul[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2, -np.pi / 2]
    eul[4:8, 1] = [np.pi / 2 - 1e-3, -np.pi / 2 + 1e-3,
                   np.pi / 2 - 1e-2, -np.pi / 2 + 2e-3]
    return np.asarray(S.euler_xyz_to_matrix(jnp.asarray(eul, jnp.float32)))


UNARY = {  # name → (input maker, skix fn)
    "euler_xyz_to_matrix": (lambda: rng.uniform(-3, 3, (5, 4, 3)),
                            S.euler_xyz_to_matrix),
    "matrix_to_euler_xyz": (_gimbal_matrices, S.matrix_to_euler_xyz),
    "euler_zyx_to_matrix": (lambda: rng.uniform(-3, 3, (7, 3)),
                            S.euler_zyx_to_matrix),
    "matrix_to_euler_zyx": (_gimbal_matrices, S.matrix_to_euler_zyx),
    "rot6d_to_matrix_cols": (lambda: rng.normal(size=(6, 6)),
                             S.rot6d_to_matrix_cols),
    "matrix_to_rot6d_cols": (_gimbal_matrices, S.matrix_to_rot6d_cols),
    "euler_xyz_to_cont6d": (lambda: rng.uniform(-3, 3, (9, 3)),
                            S.euler_xyz_to_cont6d),
    "cont6d_to_euler_xyz": (lambda: rng.normal(size=(9, 6)),
                            S.cont6d_to_euler_xyz),
    "fix_wrist_euler": (lambda: rng.uniform(-3.1, 3.1, (64, 3)),
                        S.fix_wrist_euler),
    "cont_to_model_params_body": (lambda: rng.normal(size=(3, 260)),
                                  S.cont_to_model_params_body),
    "model_params_to_cont_body": (lambda: rng.uniform(-2, 2, (3, 133)),
                                  S.model_params_to_cont_body),
    "cont_to_model_params_hand": (lambda: rng.normal(size=(4, 54)),
                                  S.cont_to_model_params_hand),
    "model_params_to_cont_hand": (lambda: rng.uniform(-2, 2, (4, 27)),
                                  S.model_params_to_cont_hand),
    "mhr_output_transform": (lambda: rng.normal(size=(2, 70, 3)) * 50,
                             S.mhr_output_transform),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_conversion_matches_skix(name):
    make, fn = UNARY[name]
    x = np.asarray(make(), np.float32)
    want = jit0(fn)(jnp.asarray(x))
    got = getattr(P, name)(_t(x))
    _close(got, want)


def test_gimbal_branch_taken_alike():
    """At y = ±π/2 both take the singular branch (z = 0); just off it both
    take the regular one."""
    m = _gimbal_matrices()
    want = np.asarray(jit0(S.matrix_to_euler_xyz)(jnp.asarray(m)))
    got = P.matrix_to_euler_xyz(_t(m)).numpy()
    assert np.all(want[:4, 2] == 0) and np.all(got[:4, 2] == 0)
    assert np.all(want[4:8, 2] != 0) and np.all(got[4:8, 2] != 0)
    _close(got, want)


def test_rotation_angle_difference():
    a, b = _gimbal_matrices(), _gimbal_matrices()[::-1].copy()
    want = jit0(S.rotation_angle_difference)(jnp.asarray(a), jnp.asarray(b))
    _close(P.rotation_angle_difference(_t(a), _t(b)), want, atol=2e-4,
           rtol=0)


def test_blend_and_assemble():
    bufs = S.get_buffers()
    pca = rng.normal(size=(3, 108)).astype(np.float32)
    mean = rng.normal(size=54).astype(np.float32) * 0.1
    comps = rng.normal(size=(54, 54)).astype(np.float32) * 0.2
    _close(P.blend_hand_pose(_t(pca[:, :54]), _t(mean), _t(comps)),
           jit0(S.blend_hand_pose)(pca[:, :54], mean, comps))
    args = [rng.normal(size=(3, 3)), rng.uniform(-1, 1, (3, 3)),
            rng.uniform(-1, 1, (3, 133)), pca, rng.normal(size=(3, 28)),
            bufs.scale_mean, bufs.scale_comps, mean, comps]
    args = [np.asarray(a, np.float32) for a in args]
    left, right = bufs.hand_joint_idxs_left, bufs.hand_joint_idxs_right
    want = jit0(lambda *a: S.assemble_model_params(
        *a[:7], hand_pose_mean=a[7], hand_pose_comps=a[8],
        hand_joint_idxs_left=left, hand_joint_idxs_right=right))(*args)
    got = P.assemble_model_params(
        *[_t(a) for a in args[:7]], hand_pose_mean=_t(mean),
        hand_pose_comps=_t(comps),
        hand_joint_idxs_left=torch.as_tensor(left, dtype=torch.long),
        hand_joint_idxs_right=torch.as_tensor(right, dtype=torch.long))
    assert got.shape == (3, 204)
    _close(got, want)


def test_default_rig_and_buffers_are_skix_data():
    a, b = S.default_rig(), P.default_rig()
    for k in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)
    np.testing.assert_array_equal(S.MHR70_PARENTS, P.MHR70_PARENTS)
    for k in S.MHRBuffers._fields:
        np.testing.assert_array_equal(getattr(S.get_buffers(), k),
                                      getattr(P.get_buffers(), k))
    for k in ("BODY_3DOF_ROT_IDXS", "BODY_1DOF_ROT_IDXS",
              "BODY_1DOF_TRANS_IDXS", "HAND_DOFS", "MHR_PARAM_HAND_MASK"):
        np.testing.assert_array_equal(getattr(S, k), getattr(P, k))
    np.testing.assert_array_equal(S._rest_joint_positions(a),
                                  P._rest_joint_positions(b))
    with pytest.raises(KeyError):
        P.get_rig("nope")


@pytest.mark.parametrize("case", ["verts", "shape_offsets", "joints_only"])
def test_rig_forward_matches_skix(case):
    """FK by depth level equals skix's joint-by-joint loop: joints, world
    rotations and scales, posed vertices and keypoints, on random model
    parameters (rotations up to ±1.5 rad, log2-scales up to ±0.3)."""
    rig_s, rig_p = S.default_rig(), P.default_rig()
    params = np.concatenate([rng.normal(size=(2, 3, 3)) * 0.5,
                             rng.uniform(-1.5, 1.5, (2, 3, 133)),
                             rng.uniform(-0.3, 0.3, (2, 3, 68))],
                            -1).astype(np.float32)
    offs = None
    if case == "shape_offsets":
        offs = (rng.normal(size=(2, 3, rig_s.rest_verts.shape[0], 3))
                ).astype(np.float32)
    verts = case != "joints_only"
    want = jit0(lambda p, o: S.rig_forward(rig_s, p, o, verts))(
        params, offs)
    got = P.rig_forward(rig_p, _t(params),
                        None if offs is None else _t(offs), verts)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
