"""skix_torch.models.semi_supervised against skix on the CPU: the pose and
trajectory lifters from the same weights (dropout 0 on both sides: the
port draws its masks from a torch generator, skix from a jax key) through
three warm-up steps and three steps of the full objective; the
parameters, the BatchNorm statistics (the labeled passes' alone) and the
losses after each step agree to 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import _CHEAP, port_variables

from skix_torch.models import semi_supervised as P

FW, CH, B = (3, 3), 32, 4


def _lifters(strided=True):
    from skix.models.videopose3d import TemporalLifter as SkixLifter
    from skix_torch.models.videopose3d import TemporalLifter

    kw = dict(filter_widths=FW, channels=CH, strided=strided, dropout=0.0)
    port = (TemporalLifter(**kw), TemporalLifter(num_joints_out=1, **kw))
    skix = (SkixLifter(**kw), SkixLifter(num_joints_out=1, **kw))
    return port, skix


def _batches(rf, L, seed):
    r = np.random.default_rng(seed)
    x_lab = (r.normal(size=(B, rf, 17, 2)) * 0.3).astype(np.float32)
    y_lab = (r.normal(size=(B, L, 17, 3)) * 0.2).astype(np.float32)
    t_lab = np.tile(np.asarray([0.1, -0.2, 5.0], np.float32),
                    (B, L, 1, 1)) + (r.normal(size=(B, L, 1, 3)) * 0.1
                                     ).astype(np.float32)
    x_un = (r.normal(size=(B, rf, 17, 2)) * 0.3).astype(np.float32)
    cam = np.asarray([1.1, 0.9, 0.02, -0.01, 0.01, -0.02, 0.003, 0.001,
                      -0.002], np.float32)
    return x_lab, y_lab, t_lab, x_un, cam


def _tree(model):
    from skix_torch.convert import state_dict_to_flax

    return state_dict_to_flax(model.state_dict())


def _close(got, want, tol=1e-4):
    from skix_torch.convert import flatten_tree

    g, w = flatten_tree(got), flatten_tree(jax.device_get(want))
    assert sorted(g) == sorted(w)
    for k in w:
        scale = max(1.0, float(np.abs(w[k]).max()))
        np.testing.assert_allclose(g[k], w[k], atol=tol * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("strided", [True, False], ids=["strided",
                                                        "dilated"])
def test_semi_supervised_steps_match_skix(strided):
    """The strided lifter (the published training variant, one output
    frame): 3 warm-up steps, then 3 of the full objective; the dilated one
    (3 output frames, the reprojection target's slice from rf // 2): 3 of
    the full objective."""
    from skix.models import semi_supervised as S
    from skix.models.train import make_optimizer as skix_optimizer
    from skix_torch.models.train import make_optimizer

    (pose, traj), (spose, straj) = _lifters(strided)
    vp, vt = port_variables(pose, 1), port_variables(traj, 2)
    s_opt = skix_optimizer(lr=5e-3, steps_per_epoch=2)
    params = {"pos": vp["params"], "traj": vt["params"]}
    s_state = S.SemiState(pos_params=vp["params"],
                          pos_stats=vp["batch_stats"],
                          traj_params=vt["params"],
                          traj_stats=vt["batch_stats"],
                          opt_state=s_opt.init(params), step=jnp.asarray(0))
    opt = make_optimizer(list(pose.parameters()) + list(traj.parameters()),
                         lr=5e-3, steps_per_epoch=2)
    state = P.SemiState(pose, traj, opt, 0)
    step = jax.jit(S.semi_supervised_step, static_argnums=(0, 1, 2, 10),
                   compiler_options=_CHEAP)
    # the strided lifter maps rf frames to 1, the dilated one rf + 2 to 3
    T = pose.rf + (0 if strided else 2)
    L = T - pose.rf + 1
    for i, warmup in enumerate([True] * 3 * strided + [False] * 3):
        x_lab, y_lab, t_lab, x_un, cam = _batches(T, L, i)
        s_state, s_loss = step(spose, straj, s_opt, s_state, x_lab, y_lab,
                               t_lab, x_un, cam, jax.random.PRNGKey(i),
                               warmup)
        state, loss = P.semi_supervised_step(
            pose, traj, opt, state, *map(torch.as_tensor, (
                x_lab, y_lab, t_lab, x_un, cam)), warmup=warmup)
        np.testing.assert_allclose(float(loss), float(s_loss), atol=1e-4,
                                   rtol=0)
        _close(_tree(pose), {"params": s_state.pos_params,
                             "batch_stats": s_state.pos_stats})
        _close(_tree(traj), {"params": s_state.traj_params,
                             "batch_stats": s_state.traj_stats})
    assert state.step == int(s_state.step) == 3 + 3 * strided


def test_losses_and_models_match_skix():
    """The two loss terms on their own, and the model pair's shapes, on the
    CPU when asked for it."""
    from skix.models import semi_supervised as S

    r = np.random.default_rng(7)
    a = r.normal(size=(2, 3, 17, 3)).astype(np.float32)
    b = r.normal(size=(2, 3, 17, 3)).astype(np.float32)
    t = (r.normal(size=(2, 3, 1, 3)) * 3).astype(np.float32)
    for p_fn, s_fn, args in (
            (P.weighted_traj_loss, S.weighted_traj_loss, (a[:, :, :1], t)),
            (P.bone_length_consistency, S.bone_length_consistency, (a, b))):
        np.testing.assert_allclose(
            float(p_fn(*map(torch.as_tensor, args))),
            float(s_fn(*map(jnp.asarray, args))), atol=1e-6, rtol=0)
    pose, traj = P.make_pose_and_traj_models(FW, CH, device="cpu")
    state = P.init_semi_state(pose, traj, seed=0)
    x = torch.zeros(1, pose.rf, 17, 2)
    assert pose(x).shape == (1, 1, 17, 3) and traj(x).shape == (1, 1, 1, 3)
    assert state.step == 0 and len(state.optimizer.params) == len(
        list(pose.parameters())) + len(list(traj.parameters()))
