"""Semi-supervised 2D→3D training: trajectory model + reprojection loss.

Port of ``skix/models/semi_supervised.py`` (the reference's
semi-supervised branch, VideoPose3D/run.py:489-948): a second *trajectory*
network (the same temporal ConvNet, one output joint = the camera-space
root position) paired with the pose network; unlabeled clips are
supervised by projecting the predicted absolute 3D pose back to 2D
through the H36M camera model and penalizing against the input
keypoints, plus a bone-length consistency term between the labeled and
unlabeled halves of the batch; the projection/bone terms ramp in after a
warmup.

skix's step is one jitted program over both parameter trees; here the two
:class:`~skix_torch.models.videopose3d.TemporalLifter` modules hold their
parameters and BatchNorm statistics, one Adam
(:func:`skix_torch.models.train.make_optimizer`) holds the moments of both,
and a step updates them in place. As in skix:

- every apply runs in training mode, and only the labeled passes'
  BatchNorm statistics are kept: the unlabeled passes normalize by their
  own batch, and their moves of the running statistics are undone;
- all four applies draw the same dropout masks (skix hands each the same
  ``dropout`` key): the generator's state is put back before each;
- the reprojection target is the unlabeled 2D input's ``L`` frames from
  ``rf // 2``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from skix_torch.geometry.camera import project_to_2d_h36m
from skix_torch.geometry.skeletons import H36M_BONES
from skix_torch.metrics.losses import mpjpe
from skix_torch.models.videopose3d import TemporalLifter
from skix_torch.utils.device import full_float32_convs, resolve_device


def make_pose_and_traj_models(filter_widths=(3, 3, 3, 3, 3),
                              channels: int = 1024, strided: bool = True,
                              device=None):
    """The pose and trajectory lifters on ``device`` (default: the card)."""
    dev = resolve_device(device)
    pose = TemporalLifter(filter_widths=filter_widths, channels=channels,
                          strided=strided)
    traj = TemporalLifter(filter_widths=filter_widths, channels=channels,
                          strided=strided, num_joints_out=1)
    return pose.to(dev), traj.to(dev)


class SemiState(NamedTuple):
    pose: TemporalLifter     # parameters and BatchNorm statistics
    traj: TemporalLifter
    optimizer: object        # one Adam over both models' parameters
    step: int


def init_semi_state(pose: TemporalLifter, traj: TemporalLifter,
                    seed: int = 0, optimizer=None) -> SemiState:
    """Seeded weights for both models (``pipelines.videopose3d.
    init_lifter``, the trajectory model from ``seed + 2`` as skix folds its
    key) and the optimizer over both (default ``make_optimizer``'s)."""
    from skix_torch.models.train import make_optimizer
    from skix_torch.pipelines.videopose3d import init_lifter

    init_lifter(pose, seed)
    init_lifter(traj, seed + 2)
    if optimizer is None:
        optimizer = make_optimizer(list(pose.parameters())
                                   + list(traj.parameters()))
    return SemiState(pose=pose, traj=traj, optimizer=optimizer, step=0)


def weighted_traj_loss(pred_traj, gt_traj):
    """Trajectory MPJPE weighted by inverse GT depth (reference run.py's
    ``w = 1/z`` weighting — distant roots matter less in pixels)."""
    w = 1.0 / torch.clamp(torch.abs(gt_traj[..., 2:3]), min=1.0)
    d = torch.linalg.norm(pred_traj - gt_traj, dim=-1, keepdim=True)
    return torch.mean(w * d)


_BONES = np.asarray(H36M_BONES)


def bone_length_consistency(pred_unlabeled, pred_labeled):
    """Penalize mean bone-length drift of the unlabeled half vs the labeled
    half (reference bone-length consistency term)."""
    def mean_bones(x):
        return torch.mean(torch.linalg.norm(
            x[..., _BONES[:, 0], :] - x[..., _BONES[:, 1], :], dim=-1),
            dim=tuple(range(x.dim() - 2)))
    return torch.mean(torch.abs(mean_bones(pred_unlabeled)
                                - mean_bones(pred_labeled)))


def _stats(model):
    return [b.clone() for b in model.buffers()]


def _put_stats(model, saved) -> None:
    with torch.no_grad():
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)


def semi_supervised_step(
    pose: TemporalLifter,
    traj: TemporalLifter,
    optimizer,
    state: SemiState,
    batch_2d_lab, batch_3d_lab, traj_3d_lab,
    batch_2d_unlab, cam_params,
    generator=None,
    warmup: bool = False,
    w_reproj: float = 1.0,
    w_bone: float = 0.1,
):
    """One combined step, the models and the optimizer updated in place →
    ``(state, loss)``, the loss detached.

    ``batch_2d_lab (B, rf, J, 2)`` normalized; ``batch_3d_lab (B, L, J, 3)``
    root-relative; ``traj_3d_lab (B, L, 1, 3)`` camera-space roots;
    ``batch_2d_unlab (B, rf, J, 2)``; ``cam_params (9,)`` H36M intrinsics
    (normalized coords), all on the models' device. ``generator``: the
    dropout masks' source (needed at a dropout rate above 0). ``warmup``
    disables the unsupervised terms.
    """
    pose.train()
    traj.train()
    g_state = generator.get_state() if generator is not None else None

    def apply(model, x):
        if generator is not None:
            generator.set_state(g_state)
        return model(x, generator)

    pred_lab = apply(pose, batch_2d_lab)
    pred_traj_lab = apply(traj, batch_2d_lab)
    loss = mpjpe(pred_lab, batch_3d_lab) + weighted_traj_loss(
        pred_traj_lab, traj_3d_lab)

    if not warmup:
        kept = _stats(pose), _stats(traj)
        pred_unlab = apply(pose, batch_2d_unlab)
        pred_traj_unlab = apply(traj, batch_2d_unlab)
        _put_stats(pose, kept[0])
        _put_stats(traj, kept[1])
        absolute = pred_unlab + pred_traj_unlab          # (B, L, J, 3)
        reproj = project_to_2d_h36m(absolute, cam_params[None])
        # compare against the center frames of the unlabeled 2D input
        L = absolute.shape[1]
        start = pose.rf // 2
        target_2d = batch_2d_unlab[:, start:start + L]
        loss = loss + w_reproj * torch.mean(
            torch.linalg.norm(reproj - target_2d, dim=-1))
        loss = loss + w_bone * bone_length_consistency(pred_unlab, pred_lab)

    optimizer.zero_grad()
    with full_float32_convs():
        loss.backward()
    optimizer.step()
    return state._replace(step=state.step + 1), loss.detach()
