"""Pattern-scoped AdamW parameter groups, layer decay and LR schedules.

Port of the parts of ``skix/models/optim.py`` that the training CLIs use
(``train_detector``'s optimizer schemes, ``warmup_cosine_schedule``), with
the lifter's Adam (:class:`ScheduledAdam`, skix's ``models/train.py``). skix builds one ``optax.multi_transform`` whose
labels come from ``fnmatch`` patterns over the ``a/b/c`` paths of the flax
params; here the same rules resolve to ``torch.optim.AdamW`` parameter
groups, each with its learning-rate schedule and weight decay, and
:class:`ClippedAdamW` steps them as optax's chain does:

- ``clip_by_global_norm``: the gradients become ``g / norm * clip`` only
  when the global norm is at least ``clip`` (``torch.nn.utils.
  clip_grad_norm_`` scales by ``clip / (norm + 1e-6)`` whenever it clips);
- ``scale_by_adam`` with eps outside the square root, then
  ``add_decayed_weights(wd)`` (skix's ``add_scheduled_decay`` where wd is
  a schedule) and the scheduled learning rate: torch's decoupled
  ``p·(1 − lr·wd)`` is optax's ``−lr·wd·p``;
- every schedule is a function of the update count before the update, in
  float32 as optax evaluates it.

Option semantics are skix's (which are the reference's): each option
(``lr``, ``weight_decay``) is a list of :class:`OptionRule`, one of them the
default that takes every parameter the scoped rules leave;
:class:`LayerDecay` splits the LR groups by the BEiT layer-decay scale.
Parameters are named by their flax paths, which the weight bridge
(``skix_torch.convert.flax_path``) gives the port's modules, so skix's
patterns apply unchanged.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

ScheduleLike = Union[float, int, Callable[[int], float]]
_F32 = np.float32


# --------------------------------------------------------------------------
# schedules: update count → value, in float32
# --------------------------------------------------------------------------
def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``."""
    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c
                                                / _F32(decay_steps),
                                                dtype=_F32))
        return float(_F32(init_value) * ((_F32(1) - _F32(alpha)) * cosine
                                         + _F32(alpha)))

    return schedule


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int,
                          cooldown_steps: int, timescale: int,
                          total_steps: int) -> Callable[[int], float]:
    """Inverse-square-root LR with linear warmup and cooldown (skix's
    ``inverse_sqrt_schedule``, the reference's
    ``InverseSquareRootParamScheduler``), including the reference's
    step-0 quirk: its trainer primes the schedulers at step 0, so the
    cooldown factor of the first step is computed with total 1."""
    shift = timescale - warmup_steps

    def schedule(count: int) -> float:
        step = _F32(count)
        lr = _F32(base_lr)
        if step > warmup_steps:
            lr = _F32(base_lr) / np.sqrt((step + _F32(shift))
                                         / _F32(timescale))
        if warmup_steps:
            lr = lr * np.minimum(_F32(1), step / _F32(warmup_steps))
        if cooldown_steps:
            total = _F32(total_steps) if step > 0 else _F32(1)
            lr = lr * np.clip((total - step) / _F32(cooldown_steps),
                              _F32(0), _F32(1))
        return float(_F32(lr))

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, end_lr: float = 0.0
                           ) -> Callable[[int], float]:
    """skix's ``warmup_cosine_schedule``: ``optax.warmup_cosine_decay_
    schedule(0, base_lr, max(warmup_steps, 1), total_steps, end_lr)``, a
    linear ramp from 0, then a cosine from ``base_lr`` to ``end_lr``."""
    warmup = max(int(warmup_steps), 1)
    peak = _F32(base_lr)
    alpha = 0.0 if base_lr == 0 else float(end_lr) / float(base_lr)
    cosine = cosine_decay_schedule(base_lr, total_steps - warmup, alpha)

    def schedule(count: int) -> float:
        if count < warmup:
            frac = _F32(1) - _F32(min(max(count, 0), warmup)) / _F32(warmup)
            return float(-peak * frac + peak)
        if total_steps - warmup <= 0:
            return float(peak)
        return cosine(count - warmup)

    return schedule


def exponential_decay_schedule(init_value: float, transition_steps: int,
                               decay_rate: float) -> Callable[[int], float]:
    """``optax.exponential_decay(init_value, transition_steps, decay_rate,
    staircase=True)``: ``init_value · decay_rate^⌊count / transition_steps⌋``
    in float32."""
    def schedule(count: int) -> float:
        if count <= 0:
            return float(_F32(init_value))
        p = np.floor(_F32(count) / _F32(transition_steps))
        return float(_F32(init_value) * np.power(_F32(decay_rate), p,
                                                  dtype=_F32))

    return schedule


def _value(schedule: ScheduleLike, count: int) -> float:
    return float(schedule(count)) if callable(schedule) else float(schedule)


class _ScaledSchedule:
    """``schedule × scale`` (a layer-decayed LR), in float32."""

    def __init__(self, schedule: ScheduleLike, scale: float):
        self.schedule, self.scale = schedule, float(scale)

    def __call__(self, count: int) -> float:
        return float(_F32(_value(self.schedule, count)) * _F32(self.scale))


# --------------------------------------------------------------------------
# option rules and layer decay
# --------------------------------------------------------------------------
@dataclasses.dataclass
class OptionRule:
    """One schedule of one optimizer option; ``param_names=None`` marks the
    default rule, which takes every parameter no other rule claims."""

    schedule: ScheduleLike
    param_names: Optional[Sequence[str]] = None


def _resolve_option(rules: Sequence[OptionRule], all_paths: Sequence[str]):
    """``[(schedule, paths)]``: a scoped rule takes the paths its patterns
    match (a pattern that matches nothing is dropped, as skix's
    ``build_optimizer`` drops it), the default rule every path left."""
    taken: set[str] = set()
    resolved = []
    for rule in rules:
        if rule.param_names is not None:
            matched = {p for pat in rule.param_names
                       for p in fnmatch.filter(all_paths, pat)}
            taken |= matched
            resolved.append((rule.schedule, frozenset(matched)))
    default, = (r.schedule for r in rules if r.param_names is None)
    resolved.append((default, frozenset(p for p in all_paths
                                        if p not in taken)))
    return resolved


def vit_layer_id(path: str, num_layers: int) -> int:
    """The BEiT layer id of a path under the ViT trunk: embeddings and the
    pre-norm 0, ``block_i`` i + 1, everything else ``num_layers + 1``."""
    if "ln_pre" in path or "pos_embed" in path or "patch_embed" in path:
        return 0
    m = re.search(r"block_(\d+)/", path)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


@dataclasses.dataclass
class LayerDecay:
    """BEiT layer-wise LR decay: a path under ``apply_to`` scales its LR
    by ``value ** (num_layers + 1 − layer_id)`` (at least ``minimum``),
    ``num_layers`` being the trunk's block count; ``overrides`` pin
    patterns to a fixed scale (``{"*pos_embed*": 1.0}``, as the
    reference's configs do)."""

    value: float
    apply_to: str
    overrides: Mapping[str, float]
    minimum: Optional[float] = None

    def scale_for(self, path: str, num_layers: int) -> float:
        lid = num_layers + 1
        if path.startswith(self.apply_to):
            rel = path[len(self.apply_to):].lstrip("/")
            for pat, val in self.overrides.items():
                if fnmatch.fnmatchcase(rel, pat) or fnmatch.fnmatchcase(
                        path, pat):
                    return float(val)
            lid = vit_layer_id(rel, num_layers)
        scale = self.value ** (num_layers + 1 - lid)
        if self.minimum is not None:
            scale = max(scale, self.minimum)
        return float(scale)


def _apply_layer_decay(lr_resolved, all_paths, ld: LayerDecay):
    ids = [int(m.group(1)) for p in all_paths if p.startswith(ld.apply_to)
           for m in [re.search(r"block_(\d+)/", p)] if m]
    num_layers = max(ids) + 1 if ids else 0
    out = []
    for sched, paths in lr_resolved:
        by_scale: dict[float, set] = {}
        for p in paths:
            by_scale.setdefault(ld.scale_for(p, num_layers), set()).add(p)
        for scale, group in sorted(by_scale.items()):
            out.append((sched if scale == 1.0 else _ScaledSchedule(sched, scale),
                        frozenset(group)))
    return out


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
class _AdamMoments:
    """``state()``/``load_state()`` of an optimizer holding ``params``, a
    torch Adam or AdamW ``opt`` over them and the update ``count``: the
    first and second moments by parameter and the count, the parts of
    optax's ``ScaleByAdamState``."""

    def state(self) -> tuple[list, list]:
        """``(mu, nu)``: per parameter, in order, its moments (zeros before
        the first update)."""
        mu, nu = [], []
        for p in self.params:
            st = self.opt.state.get(p, {})
            mu.append(st.get("exp_avg", torch.zeros_like(p)).detach())
            nu.append(st.get("exp_avg_sq", torch.zeros_like(p)).detach())
        return mu, nu

    def load_state(self, mu, nu, count: int) -> None:
        self.count = int(count)
        for p, m, v in zip(self.params, mu, nu):
            self.opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.as_tensor(m, dtype=p.dtype).to(p.device),
                "exp_avg_sq": torch.as_tensor(v, dtype=p.dtype).to(p.device)}


class ClippedAdamW(_AdamMoments):
    """optax's ``chain(clip_by_global_norm(clip), <per-group AdamW>)`` on
    torch parameters, with optax's (and torch's) default betas and eps.
    ``groups``: dicts with ``params``, ``lr`` and ``weight_decay`` (each a
    float or a schedule of the update count). A parameter that the loss
    does not reach (no ``.grad``) gets a zero gradient, as jax gives it, so
    that weight decay still moves it."""

    def __init__(self, groups: Sequence[dict], clip: float):
        self.groups = [dict(g, params=[p for p in g["params"]
                                       if p.requires_grad]) for g in groups]
        self.params = [p for g in self.groups for p in g["params"]]
        self.clip = float(clip)
        self.count = 0
        self.opt = torch.optim.AdamW(
            [{"params": g["params"], "lr": _value(g["lr"], 0),
              "weight_decay": _value(g["weight_decay"], 0)}
             for g in self.groups])

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> float:
        """One update; returns the global gradient norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = float(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads))))
        if not norm < self.clip:
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.clip)
        for spec, group in zip(self.groups, self.opt.param_groups):
            group["lr"] = _value(spec["lr"], self.count)
            group["weight_decay"] = _value(spec["weight_decay"], self.count)
        self.opt.step()
        self.count += 1
        return norm


def construct_optimizer(named_params,
                        options: Mapping[str, Sequence[OptionRule]],
                        grad_clip_norm: float,
                        layer_decay: Optional[LayerDecay] = None):
    """skix's ``construct_optimizer`` on ``named_params``, an iterable of
    ``(flax path, parameter)``, and ``options`` holding the ``lr`` and
    ``weight_decay`` rules: returns ``(ClippedAdamW, groups)``, each group
    a dict of its sorted ``paths``, ``lr`` and ``weight_decay``."""
    by_path = dict(named_params)
    all_paths = sorted(by_path)
    lr_res = _resolve_option(options["lr"], all_paths)
    if layer_decay is not None:
        lr_res = _apply_layer_decay(lr_res, all_paths, layer_decay)
    wd_res = _resolve_option(options["weight_decay"], all_paths)
    groups = [{"paths": sorted(lr_p & wd_p), "lr": lr_s, "weight_decay": wd_s}
              for lr_s, lr_p in lr_res for wd_s, wd_p in wd_res
              if lr_p & wd_p]
    opt = ClippedAdamW([dict(g, params=[by_path[p] for p in g["paths"]])
                        for g in groups], grad_clip_norm)
    return opt, groups


class ScheduledAdam(_AdamMoments):
    """``optax.adam(schedule, eps=eps)`` on torch parameters (the lifter's
    optimizer): the learning rate of each update is the schedule at the
    update count before it."""

    def __init__(self, params, schedule: ScheduleLike, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.Adam(self.params, lr=_value(schedule, 0),
                                    eps=eps)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = _value(self.schedule, self.count)
        self.opt.step()
        self.count += 1

