"""2D→3D temporal-conv lifting network (VideoPose3D family).

Port of ``skix/models/videopose3d.py``: a dilated 1-D temporal ConvNet —
an expand conv J·2 → C channels, B residual blocks of (dilated width-w
conv → BN → ReLU → dropout → 1×1 conv → BN → ReLU → dropout) with sliced
residual skips, and a 1×1 ``shrink`` conv (with bias) to J·3. The modules
carry skix's flax names (``expand_conv``, ``expand_bn``, ``conv_{i}_a``,
``bn_{i}_a``, ``conv_{i}_b``, ``bn_{i}_b``, ``shrink``), so
``skix_torch.convert.flax_to_state_dict`` of skix's variables loads as it
is. BatchNorm is torch's with eps 1e-5 (in eval mode the same affine map
as flax's). In training mode (``model.train()``) every BatchNorm is
flax's instead (``layers.batch_norm_train``: the biased batch variance,
running statistics moved at skix's momentum 0.9, where torch's train mode
would move them with the unbiased variance), and dropout draws its keep
mask from the ``generator`` that the caller passes.

Precision: float32 throughout. On the card the forward runs with cuDNN's
TF32 turned off inside its own scope (PyTorch lets cuDNN convolutions use
TF32 by default, ~1e-3 from float32 at these widths), so the card
computes the convolutions in full float32, as the CPU does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from skix_torch.geometry.skeletons import H36M_LEFT, H36M_RIGHT, flip_keypoints
from skix_torch.models.layers import batch_norm_train
from skix_torch.utils.device import full_float32_convs


def receptive_field(filter_widths: Sequence[int]) -> int:
    """Total receptive field in frames (product of filter widths)."""
    rf = 1
    for w in filter_widths:
        rf *= w
    return rf


class TemporalLifter(nn.Module):
    """Input ``(B, T, J_in, C_in)`` → ``(B, T', J_out, 3)`` with
    ``T' = T − receptive_field + 1`` (VALID convolutions; pad with
    :func:`pad_for_inference` for full-sequence output). ``strided``: stride
    in place of dilation (the single-output-frame training variant)."""

    def __init__(self, num_joints_in: int = 17, in_features: int = 2,
                 num_joints_out: int = 17,
                 filter_widths: Sequence[int] = (3, 3, 3, 3, 3),
                 channels: int = 1024, dropout: float = 0.25,
                 causal: bool = False, strided: bool = False):
        super().__init__()
        self.num_joints_in, self.in_features = num_joints_in, in_features
        self.num_joints_out = num_joints_out
        self.filter_widths = tuple(filter_widths)
        self.causal, self.strided = causal, strided
        fw = self.filter_widths
        self.dropout = float(dropout)
        self.expand_conv = nn.Conv1d(num_joints_in * in_features, channels,
                                     fw[0], stride=fw[0] if strided else 1,
                                     bias=False)
        self.expand_bn = nn.BatchNorm1d(channels, eps=1e-5, momentum=0.1)
        dilation = fw[0]
        for i, w in enumerate(fw[1:]):
            self.add_module(f"conv_{i}_a", nn.Conv1d(
                channels, channels, w, stride=w if strided else 1,
                dilation=1 if strided else dilation, bias=False))
            self.add_module(f"bn_{i}_a", nn.BatchNorm1d(channels, eps=1e-5))
            self.add_module(f"conv_{i}_b", nn.Conv1d(channels, channels, 1,
                                                     bias=False))
            self.add_module(f"bn_{i}_b", nn.BatchNorm1d(channels, eps=1e-5))
            dilation *= w
        self.shrink = nn.Conv1d(channels, num_joints_out * 3, 1, bias=True)

    @property
    def rf(self) -> int:
        return receptive_field(self.filter_widths)

    def _bn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, name)
        if not self.training:
            return F.batch_norm(h, bn.running_mean, bn.running_var,
                                bn.weight, bn.bias, False, 0.0, bn.eps)
        return batch_norm_train(h, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, 0.9, bn.eps, (0, 2))

    def _drop(self, h: torch.Tensor, generator) -> torch.Tensor:
        """flax's ``Dropout``: keep with probability 1 − rate, scaled by
        1 / (1 − rate); the identity outside training or at rate 0."""
        if not self.training or self.dropout == 0.0:
            return h
        keep = 1.0 - self.dropout
        mask = torch.rand(h.shape, generator=generator,
                          device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), device=h.device))

    def _forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        B, T = x.shape[0], x.shape[1]
        h = x.reshape(B, T, -1).transpose(1, 2)             # (B, F, T)
        drop = lambda t: self._drop(t, generator)          # noqa: E731
        h = drop(F.relu(self._bn("expand_bn", self.expand_conv(h))))
        fw = self.filter_widths
        dilation = fw[0]
        for i, w in enumerate(fw[1:]):
            if self.strided:
                shift = (w // 2) if self.causal else 0
                res = h[:, :, shift + w // 2::w]
            else:
                pad = (w - 1) * dilation // 2
                shift = (w // 2) * dilation if self.causal else 0
                res = h[:, :, pad + shift: h.shape[2] - pad + shift]
            conv_a = getattr(self, f"conv_{i}_a")
            h = drop(F.relu(self._bn(f"bn_{i}_a", conv_a(h))))
            h = getattr(self, f"conv_{i}_b")(h)
            h = res + drop(F.relu(self._bn(f"bn_{i}_b", h)))
            dilation *= w
        out = self.shrink(h).transpose(1, 2)                 # (B, T', J·3)
        return out.reshape(B, out.shape[1], self.num_joints_out, 3)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``generator``: the dropout draws' source in training mode (on
        ``x``'s device; needed when the dropout rate is above 0)."""
        with full_float32_convs():
            return self._forward(x, generator)


# --------------------------------------------------------------------------
# Reference checkpoint conversion
# --------------------------------------------------------------------------
def convert_reference_state_dict(state_dict, filter_widths=(3, 3, 3, 3, 3)
                                 ) -> dict[str, torch.Tensor]:
    """A VideoPose3D ``model_pos`` state dict (``expand_conv``,
    ``expand_bn``, ``layers_conv.{2i,2i+1}``, ``layers_bn.{2i,2i+1}``,
    ``shrink``) → the state dict of :class:`TemporalLifter`. Both are torch
    Conv1d/BatchNorm1d layouts, so only the names change."""
    names = {"expand_conv": "expand_conv", "expand_bn": "expand_bn",
             "shrink": "shrink"}
    for i in range(len(filter_widths) - 1):
        names[f"layers_conv.{2 * i}"] = f"conv_{i}_a"
        names[f"layers_conv.{2 * i + 1}"] = f"conv_{i}_b"
        names[f"layers_bn.{2 * i}"] = f"bn_{i}_a"
        names[f"layers_bn.{2 * i + 1}"] = f"bn_{i}_b"
    out = {}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if module in names:
            out[f"{names[module]}.{leaf}"] = torch.as_tensor(
                np.asarray(value.detach().cpu() if hasattr(value, "detach")
                           else value))
    return out


def fold_batchnorm(state_dict: dict[str, torch.Tensor], eps: float = 1e-5
                   ) -> dict[str, torch.Tensor]:
    """Fold each BatchNorm's statistics into its affine part: scale ←
    scale/√(var+ε), bias ← bias − mean·scale', mean ← 0, var ← 1 − ε. The
    eval-mode outputs are the same; the module applies unchanged."""
    out = {k: v.clone() for k, v in state_dict.items()}
    for key in state_dict:
        if not key.endswith(".running_var"):
            continue
        name = key[:-len(".running_var")]
        inv = 1.0 / torch.sqrt(state_dict[key] + eps)
        scale = state_dict[f"{name}.weight"] * inv
        out[f"{name}.weight"] = scale
        out[f"{name}.bias"] = (state_dict[f"{name}.bias"]
                               - state_dict[f"{name}.running_mean"] * scale)
        out[f"{name}.running_mean"] = torch.zeros_like(inv)
        out[f"{name}.running_var"] = torch.ones_like(inv) - eps
    return out


# --------------------------------------------------------------------------
# Full-sequence inference
# --------------------------------------------------------------------------
def pad_for_inference(kpts_2d: torch.Tensor, rf: int, causal_shift: int = 0
                      ) -> torch.Tensor:
    """Edge-pad a ``(T, J, 2)`` sequence by rf//2 on each side."""
    half = rf // 2
    return torch.cat([kpts_2d[:1].expand(half + causal_shift, -1, -1), kpts_2d,
                      kpts_2d[-1:].expand(half - causal_shift, -1, -1)], dim=0)


@torch.no_grad()
def infer_sequence(model: TemporalLifter, kpts_2d: torch.Tensor,
                   flip_augment: bool = True, left=None, right=None
                   ) -> torch.Tensor:
    """Lift a normalized-2D sequence ``(T, J, 2)`` → ``(T, J, 3)``; with
    flip augmentation the mirrored input's prediction, mirrored back, is
    averaged in (one batch of two sequences)."""
    left = H36M_LEFT if left is None else left
    right = H36M_RIGHT if right is None else right
    x = pad_for_inference(kpts_2d, model.rf)[None]
    if flip_augment:
        pred = model(torch.cat([x, flip_keypoints(x, left, right)]))
        return 0.5 * (pred[0] + flip_keypoints(pred[1], left, right))
    return model(x)[0]
