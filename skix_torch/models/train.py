"""Training step for the 2D→3D lifter.

Port of ``skix/models/train.py``: Adam with the reference's per-epoch
exponential decay (lr × 0.95 an epoch, VideoPose3D ``common/arguments.py``),
the MPJPE objective, BatchNorm statistics moved as flax moves them and
dropout drawn from an explicit generator (``TemporalLifter`` in training
mode). skix jits one functional step over a device mesh; here a step is the
train-mode forward, autograd and :class:`~skix_torch.models.optim.
ScheduledAdam` on one device, updating the model in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skix_torch.metrics.losses import mpjpe
from skix_torch.models.optim import ScheduledAdam, exponential_decay_schedule
from skix_torch.models.videopose3d import TemporalLifter
from skix_torch.utils.device import full_float32_convs


class TrainState(NamedTuple):
    model: TemporalLifter        # parameters and BatchNorm statistics
    optimizer: ScheduledAdam     # Adam's moments and update count
    step: int


def make_optimizer(params, lr: float = 1e-3, lr_decay: float = 0.95,
                   steps_per_epoch: int = 1000) -> ScheduledAdam:
    """Adam (eps 1e-8) with ``optax.exponential_decay(lr, steps_per_epoch,
    lr_decay, staircase=True)``."""
    return ScheduledAdam(params, exponential_decay_schedule(
        lr, steps_per_epoch, lr_decay), eps=1e-8)


def init_state(model: TemporalLifter, seed: int = 0,
               optimizer: ScheduledAdam | None = None) -> TrainState:
    """Seeded weights (``pipelines.videopose3d.init_lifter``, drawn on the
    CPU), BatchNorm statistics at mean 0 and variance 1, and the
    optimizer (default :func:`make_optimizer`'s)."""
    from skix_torch.pipelines.videopose3d import init_lifter

    init_lifter(model, seed)
    return TrainState(model, optimizer or make_optimizer(model.parameters()),
                      0)


def train_step(state: TrainState, batch_2d, batch_3d, generator=None):
    """One supervised step: ``batch_2d (B, rf, J, 2)``, ``batch_3d (B,
    out_len, J, 3)`` on the model's device, ``generator`` the dropout
    draws' source → ``(state, loss)``, the loss detached. The backward's
    convolutions run in full float32 too (cuDNN's TF32 off)."""
    model, opt = state.model, state.optimizer
    model.train()
    loss = mpjpe(model(batch_2d, generator), batch_3d)
    opt.zero_grad()
    with full_float32_convs():
        loss.backward()
    opt.step()
    return state._replace(step=state.step + 1), loss.detach()
