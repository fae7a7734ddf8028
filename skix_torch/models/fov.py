"""Field-of-view estimation from a single image.

Port of ``skix/models/fov.py`` (the reference's FOV-estimator slot,
SURVEY.md §2.7): a compact convnet regresses (fov_h, fov_w) in radians,
and converters map FOV ↔ focal length in pixels. The module carries
flax's names (``conv_{i}``, ``norm_{i}``, ``head``), so skix's variables
load through the weight bridge (:func:`load_fov_estimator`). Its
convolutions run with cuDNN's TF32 off, as float32 in skix.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from skix_torch.convert import flax_to_state_dict, load_into
from skix_torch.models.layers import Conv, Dense, GroupNorm
from skix_torch.utils.device import full_float32_convs, resolve_device

_LO, _HI = math.radians(20.0), math.radians(120.0)


def fov_to_focal(fov_rad, size_px):
    """focal = (size/2) / tan(fov/2)."""
    fov_rad = torch.as_tensor(fov_rad)
    return (size_px / 2.0) / torch.tan(torch.clamp(fov_rad / 2.0, 1e-4, 1.55))


def focal_to_fov(focal_px, size_px):
    focal_px = torch.as_tensor(focal_px)
    return 2.0 * torch.atan((size_px / 2.0) / torch.clamp(focal_px, min=1e-4))


class FovEstimator(nn.Module):
    """Image (B, H, W, 3) in [0,1] → (B, 2) FOV (h, w) in radians,
    bounded to (20°, 120°): ``depth`` stride-2 3×3 convs (flax's SAME
    padding), each with GroupNorm(8) and SiLU, a mean pool and a Dense."""

    def __init__(self, width: int = 32, depth: int = 4):
        super().__init__()
        chans = [3] + [width * (1 + i // 2) for i in range(depth)]
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv_{i}", Conv(chans[i], chans[i + 1], 3,
                                              stride=2))
            self.add_module(f"norm_{i}", GroupNorm(8, chans[i + 1]))
        self.head = Dense(chans[-1], 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        h = (images - 0.5) / 0.5
        with full_float32_convs():
            for i in range(self.depth):
                h = getattr(self, f"conv_{i}")(h)
                h = nn.functional.silu(getattr(self, f"norm_{i}")(h))
        raw = self.head(h.mean(dim=(1, 2)))
        return _LO + (_HI - _LO) * torch.sigmoid(raw)


def load_fov_estimator(variables, width: int = 32, depth: int = 4,
                       device=None) -> FovEstimator:
    """A FovEstimator on ``device`` (default ``cuda``) holding skix's
    variables (nested dicts of numpy arrays, or a flat checkpoint npz),
    converted by the weight bridge: every leaf of the tree is a parameter
    of the module, or this raises."""
    model = FovEstimator(width=width, depth=depth)
    unused = load_into(model, flax_to_state_dict(variables))
    if unused:
        raise ValueError(f"variables the FovEstimator does not have: {unused}")
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def estimate_focal_lengths(model: FovEstimator, frames_u8,
                           batch_size: int = 16) -> np.ndarray:
    """Per-frame (fx, fy) pixels for a uint8 clip ``(T, H, W, 3)``, on the
    model's device, ``batch_size`` frames a forward."""
    T, H, W = frames_u8.shape[:3]
    device = next(model.parameters()).device
    outs = []
    for s in range(0, T, batch_size):
        chunk = torch.as_tensor(np.asarray(frames_u8[s:s + batch_size]),
                                device=device).to(torch.float32) / 255.0
        fov = model(chunk)
        fy = fov_to_focal(fov[:, 0], H)
        fx = fov_to_focal(fov[:, 1], W)
        outs.append(torch.stack([fx, fy], -1).cpu().numpy())
    return np.concatenate(outs, 0)
