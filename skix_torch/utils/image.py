"""``jax.image.resize`` as the port needs it: bilinear (up and down) and
nearest, on any axes of a tensor.

jax resizes bilinearly with a triangle kernel at half-pixel centers whose
weights it renormalizes over the in-range samples, and it antialiases when
it downsamples (the kernel widens by 1/scale). ``F.interpolate`` clamps
indices and does not antialias, so the two agree on a plain upsample but
not on a downsample such as the 1280 → 1008 axis of a video frame. The
port therefore builds jax's weight matrices (``compute_weight_mat``) and
applies them as one product per resized axis; an axis whose size does not
change is left as it is, as jax leaves it. Nearest takes jax's source
index ``floor((i + 0.5) · n_in / n_out)`` computed in float32.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_in, n_out)`` float32 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis: a triangle kernel at half-pixel centers,
    widened by 1/scale when downsampling (antialiasing), columns normalized
    to sum 1, zero for samples outside the input."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output sample of ``jax.image.resize(...,
    "nearest")`` along one axis."""
    offsets = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
               * np.float32(n_in) / np.float32(n_out))
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _weights_on(n_in: int, n_out: int, method: str, device, dtype):
    """The bilinear weight matrix or nearest index vector of one axis on
    ``device``, built once per size pair (a video's frames all share it)."""
    if method == "nearest":
        return torch.as_tensor(nearest_indices(n_in, n_out), device=device)
    return torch.as_tensor(bilinear_weights(n_in, n_out), device=device,
                           dtype=dtype)


def resize(x: torch.Tensor, shape: Sequence[int],
           method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` "bilinear" or
    "nearest". Bilinear returns float32 (integer inputs are promoted, as jax
    promotes them); nearest keeps the dtype."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match rank {x.dim()}")
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported resize method {method!r}")
    if method == "bilinear" and not x.is_floating_point():
        x = x.to(torch.float32)
    for d, n_out in enumerate(shape):
        n_in = x.shape[d]
        if n_in == n_out:
            continue
        w = _weights_on(n_in, n_out, method, x.device, x.dtype)
        if method == "nearest":
            x = x.index_select(d, w)
        else:
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
