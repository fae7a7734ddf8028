"""Generic training loop: grad accumulation, clipping, checkpoint/resume,
validation.

Port of ``skix/models/trainer.py`` (the reference SAM3 ``Trainer``,
sam3/train/trainer.py:145,306,374,556: grad accumulation, gradient
clipping, checkpoint save/resume, the val loop) on one device. skix's
state is a params pytree and an optax state, its step one jitted
program; here the model holds the parameters, the optimizer holds its
moments, and a step is the forward, autograd and the optimizer's update
in place:

- the default optimizer is optax's ``chain(clip_by_global_norm(clip),
  adam(lr) | adamw(lr, weight_decay))`` (b1 0.9, b2 0.999, eps 1e-8, the
  decay decoupled): a :class:`~skix_torch.models.optim.ClippedAdamW` of one
  group. ``tx=`` takes the port's ``construct_optimizer`` result (the
  optimizer, or its ``(optimizer, groups)`` pair) for pattern-scoped
  groups, schedules and layer decay;
- ``grad_accum_steps > 1`` is optax's ``MultiSteps`` (:class:`MultiSteps`):
  the running mean of k micro-gradients, the inner update on the k-th, the
  parameters unchanged in between; its accumulator and counters go into
  the checkpoint, so a resume in the middle of an accumulation continues
  exactly;
- ``loss_fn(model, batch, generator)`` replaces skix's ``loss_fn(params,
  batch, rng)``: one generator on the model's device, advancing with every
  draw, in place of a split key a step.

Checkpoints are ``step_XXXXXXXX.npz`` (``utils.checkpointing``:
``params/...`` and ``batch_stats/...`` in flax's names, Adam's moments
``opt_state/mu/...`` and ``opt_state/nu/...``, ``opt_state/count``; with
accumulation ``opt_state/acc_grads/...``, ``opt_state/mini_step`` and
``opt_state/gradient_step``) with skix's ``.meta.json`` sidecar.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from skix_torch.models.optim import ClippedAdamW
from skix_torch.utils.checkpointing import (latest_checkpoint_path,
                                            load_tree_into, module_tree,
                                            restore_pytree, save_pytree)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1
    max_steps: int = 1000
    log_every: int = 50
    checkpoint_every: int = 500
    keep_last: int = 3
    val_every: int = 0  # 0 = no validation


class MultiSteps:
    """optax's ``MultiSteps(inner, every_k)`` with the gradient mean: each
    :meth:`step` folds the parameters' gradients into the running mean
    ``acc + (g − acc) / (n + 1)`` (optax's Welford form); on the k-th the
    inner optimizer steps on the mean and the accumulator returns to zero.
    A parameter without a gradient adds zeros, as jax gives it."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)
        self.params = list(inner.params)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.gradient_step = 0

    def zero_grad(self):
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, a in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / (n + 1))
        if n == self.every_k - 1:
            for p, a in zip(self.params, self.acc):
                p.grad = a.clone()
            self.inner.step()
            for a in self.acc:
                a.zero_()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.every_k


class TrainerState(NamedTuple):
    model: torch.nn.Module   # the parameters (and buffers), updated in place
    optimizer: Any           # the moments, counts and accumulator
    step: int


def _inner(opt):
    return opt.inner if isinstance(opt, MultiSteps) else opt


class Trainer:
    """Minimal trainer: give it ``loss_fn(model, batch, generator)``
    returning a scalar tensor, the model (its initial weights) and a batch
    iterator."""

    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 cfg: TrainerConfig, ckpt_dir: Optional[str | Path] = None,
                 tx=None):
        """``tx`` overrides the config-built optimizer — pass the result
        of :func:`skix_torch.models.optim.construct_optimizer` over this
        model's parameters for pattern-scoped param groups / schedulers /
        layer decay (reference construct_optimizer semantics)."""
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        if tx is None:
            tx = ClippedAdamW([{"params": list(model.parameters()),
                                "lr": cfg.lr,
                                "weight_decay": cfg.weight_decay}],
                              cfg.grad_clip_norm)
        elif isinstance(tx, tuple):     # construct_optimizer's (opt, groups)
            tx = tx[0]
        self.optimizer = (MultiSteps(tx, cfg.grad_accum_steps)
                          if cfg.grad_accum_steps > 1 else tx)
        self.state = TrainerState(model=model, optimizer=self.optimizer,
                                  step=0)
        self._names = {id(p): n for n, p in model.named_parameters()}

    def _step(self, batch, generator) -> torch.Tensor:
        model, opt = self.state.model, self.optimizer
        loss = self.loss_fn(model, batch, generator)
        opt.zero_grad()
        loss.backward()
        opt.step()
        self.state = self.state._replace(step=self.state.step + 1)
        return loss.detach()

    # ------------------ checkpointing ------------------
    def _per_param(self, tensors) -> dict:
        """One tensor per optimized parameter, as the flax tree of the
        parameters' paths."""
        from skix_torch.convert import state_dict_to_flax

        inner = _inner(self.optimizer)
        return state_dict_to_flax({self._names[id(p)]: t for p, t
                                   in zip(inner.params, tensors)})

    def _from_tree(self, tree) -> list:
        """The inverse of :meth:`_per_param`, in the optimizer's order."""
        from skix_torch.convert import flax_to_state_dict

        sd = flax_to_state_dict(tree)
        return [sd[self._names[id(p)]] for p in _inner(self.optimizer).params]

    def _tree(self) -> dict:
        inner = _inner(self.optimizer)
        mu, nu = inner.state()
        opt_state = {"mu": self._per_param(mu), "nu": self._per_param(nu),
                     "count": np.int32(inner.count)}
        if isinstance(self.optimizer, MultiSteps):
            opt_state.update(
                acc_grads=self._per_param(self.optimizer.acc),
                mini_step=np.int32(self.optimizer.mini_step),
                gradient_step=np.int32(self.optimizer.gradient_step))
        return {**module_tree(self.state.model), "opt_state": opt_state}

    def save(self, step: int) -> None:
        if self.ckpt_dir is None:
            return
        save_pytree(self.ckpt_dir / f"step_{step:08d}", self._tree(),
                    metadata={"step": step}, keep_last=self.cfg.keep_last)

    def try_resume(self) -> int:
        if self.ckpt_dir is None:
            return 0
        found = latest_checkpoint_path(self.ckpt_dir)
        if not found:
            return 0
        path, meta = found
        tree = restore_pytree(path)
        load_tree_into(self.state.model, {k: tree[k] for k in
                                          ("params", "batch_stats")
                                          if k in tree})
        ost = tree["opt_state"]
        _inner(self.optimizer).load_state(self._from_tree(ost["mu"]),
                                          self._from_tree(ost["nu"]),
                                          int(ost["count"]))
        if isinstance(self.optimizer, MultiSteps):
            with torch.no_grad():
                for a, v in zip(self.optimizer.acc,
                                self._from_tree(ost["acc_grads"])):
                    a.copy_(v)
            self.optimizer.mini_step = int(ost["mini_step"])
            self.optimizer.gradient_step = int(ost["gradient_step"])
        step = int(meta.get("step", 0))
        self.state = self.state._replace(step=step)
        log.info("resumed from %s (step %d)", path, step)
        return step

    # ------------------ loops ------------------
    def fit(self, batches: Iterable, generator=None,
            val_fn: Optional[Callable] = None) -> dict:
        """Run up to cfg.max_steps over ``batches``; returns history.
        ``generator``: the loss's draws (default: seeded 0 on the model's
        device); ``val_fn(model)`` → a number."""
        if generator is None:
            dev = next(self.state.model.parameters()).device
            generator = torch.Generator(device=dev).manual_seed(0)
        start = self.try_resume()
        history = {"loss": [], "val": []}
        step = start
        for batch in batches:
            if step >= self.cfg.max_steps:
                break
            loss = self._step(batch, generator)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.max_steps:
                lv = float(loss)
                history["loss"].append((step, lv))
                log.info("step %d: loss %.5f", step, lv)
            if self.cfg.checkpoint_every and \
                    step % self.cfg.checkpoint_every == 0:
                self.save(step)
            if val_fn and self.cfg.val_every and \
                    step % self.cfg.val_every == 0:
                v = float(val_fn(self.state.model))
                history["val"].append((step, v))
                log.info("step %d: val %.5f", step, v)
        self.save(step)
        return history
