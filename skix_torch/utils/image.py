"""``jax.image.resize`` as the port needs it: bilinear (up and down),
bicubic and nearest, on any axes of a tensor.

jax resizes bilinearly with a triangle kernel at half-pixel centers whose
weights it renormalizes over the in-range samples, and it antialiases when
it downsamples (the kernel widens by 1/scale). ``F.interpolate`` clamps
indices and does not antialias, so the two agree on a plain upsample but
not on a downsample such as the 1280 → 1008 axis of a video frame. The
port therefore builds jax's weight matrices (``compute_weight_mat``) and
applies them as one product per resized axis; an axis whose size does not
change is left as it is, as jax leaves it. Nearest takes jax's source
index ``floor((i + 0.5) · n_in / n_out)`` computed in float32.

:func:`scale_and_translate_weights` builds the same triangle weights for
``jax.image.scale_and_translate(..., method="linear")`` (antialiased), one
matrix per batch row, for crops whose scale and translation differ from
frame to frame; :func:`scale_and_translate` applies them to a batch of
channels-last images as two batched products.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax's bicubic kernel (Keys, a = −0.5) at distances ``x ≥ 0``."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def bilinear_weights(n_in: int, n_out: int, cubic: bool = False
                     ) -> np.ndarray:
    """``(n_in, n_out)`` float32 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis: a triangle kernel at half-pixel centers,
    widened by 1/scale when downsampling (antialiasing), columns normalized
    to sum 1, zero for samples outside the input. ``cubic``: jax's
    ``"bicubic"`` (the Keys kernel in place of the triangle)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = (_keys_cubic(x) if cubic
         else np.maximum(np.float32(0.0), np.float32(1.0) - x))
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
    return torch.as_tensor(bilinear_weights(n_in, n_out,
                                            cubic=method == "bicubic"),
                           device=device, dtype=dtype)


def resize(x: torch.Tensor, shape: Sequence[int],
           method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` "bilinear"
    (jax's "linear" too), "bicubic" or "nearest". Bilinear and bicubic
    return float32 (integer inputs are promoted, as jax promotes them);
    nearest keeps the dtype."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match rank {x.dim()}")
    if method not in ("bilinear", "bicubic", "nearest"):
        raise ValueError(f"unsupported resize method {method!r}")
    if method != "nearest" and not x.is_floating_point():
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


def scale_and_translate_weights(n_in: int, n_out: int, scale: torch.Tensor,
                                translation: torch.Tensor) -> torch.Tensor:
    """``(B, n_in, n_out)`` float32 weights of ``jax.image.scale_and_translate
    (..., method="linear")`` along one axis, for per-row ``scale`` and
    ``translation`` ``(B,)``: output sample ``i`` reads input location
    ``(i + 0.5 − translation) / scale − 0.5``, with a triangle kernel
    widened by 1/scale when downsampling, columns normalized to sum 1 over
    the in-range inputs, and zero where the location falls outside the
    input."""
    scale = scale.to(torch.float32)[:, None]
    translation = translation.to(torch.float32)[:, None]
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale - translation * inv_scale - 0.5)      # (B, n_out)
    x = torch.abs(sample_f[:, None, :]
                  - torch.arange(n_in, dtype=torch.float32,
                                 device=dev)[None, :, None]) / kernel_scale[
                                     :, :, None]
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def scale_and_translate(images: torch.Tensor, out_hw, scale: torch.Tensor,
                        translation: torch.Tensor) -> torch.Tensor:
    """Per-row ``jax.image.scale_and_translate(image, (H', W', C), (0, 1),
    scale[b], translation[b], method="linear")`` over a batch ``images (B,
    H, W, C)`` float32: ``scale`` and ``translation`` are ``(B, 2)`` as
    (y, x). Returns ``(B, H', W', C)`` float32."""
    B, H, W, C = images.shape
    Ho, Wo = out_hw
    wy = scale_and_translate_weights(H, Ho, scale[:, 0], translation[:, 0])
    wx = scale_and_translate_weights(W, Wo, scale[:, 1], translation[:, 1])
    # x axis: (B, H·C, W) @ (B, W, W') → (B, H, C, W')
    t = torch.matmul(images.permute(0, 1, 3, 2).reshape(B, H * C, W), wx)
    # y axis: (B, H', H) @ (B, H, C·W') → (B, H', C, W')
    t = torch.matmul(wy.transpose(1, 2), t.reshape(B, H, C * Wo))
    return t.reshape(B, Ho, C, Wo).permute(0, 1, 3, 2)
