"""Convolutional KL-VAE of the image-edit latent space.

Port of ``skix/models/vae.py``, with skix's parameter tree: a conv stem,
down stages (a resnet block and a stride-2 conv each), a mid block and the
2·C_latent moments (mean, log-variance); the decoder mirrors it with
nearest ×2 upsampling. GroupNorm in 8 groups, SiLU, flax's ``SAME``
padding (the stride-2 conv of an even axis pads 0 before and 1 after:
``layers.Conv``). Images are channels-last ``(B, H, W, C)``. The
convolutions run in float32 with cuDNN's TF32 off
(``utils.device.full_float32_convs``), as skix runs them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, GroupNorm, init_like_flax
from skix_torch.utils.device import full_float32_convs


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(8, in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3)
        self.norm2 = GroupNorm(8, out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3)
        self.shortcut = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class Encoder(nn.Module):
    def __init__(self, ch: int = 64, ch_mults: Sequence[int] = (1, 2, 4),
                 latent_channels: int = 16):
        super().__init__()
        self.n = len(ch_mults)
        self.stem = Conv(3, ch, 3)
        prev = ch
        for i, m in enumerate(ch_mults):
            self.add_module(f"down_{i}_block", ResnetBlock(prev, ch * m))
            self.add_module(f"down_{i}_conv", Conv(ch * m, ch * m, 3, 2))
            prev = ch * m
        self.mid = ResnetBlock(prev, prev)
        self.norm_out = GroupNorm(8, prev)
        self.moments = Conv(prev, 2 * latent_channels, 3)

    def forward(self, x):
        h = self.stem(x)
        for i in range(self.n):
            h = getattr(self, f"down_{i}_block")(h)
            h = getattr(self, f"down_{i}_conv")(h)
        h = self.mid(h)
        return self.moments(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 64, ch_mults: Sequence[int] = (1, 2, 4),
                 out_channels: int = 3, latent_channels: int = 16):
        super().__init__()
        self.n = len(ch_mults)
        prev = ch * ch_mults[-1]
        self.stem = Conv(latent_channels, prev, 3)
        self.mid = ResnetBlock(prev, prev)
        for i, m in enumerate(reversed(ch_mults)):
            self.add_module(f"up_{i}_conv", Conv(prev, ch * m, 3))
            self.add_module(f"up_{i}_block", ResnetBlock(ch * m, ch * m))
            prev = ch * m
        self.norm_out = GroupNorm(8, prev)
        self.out = Conv(prev, out_channels, 3)

    def forward(self, z):
        h = self.mid(self.stem(z))
        for i in range(self.n):
            # jax's nearest ×2: source index floor((i + 0.5) / 2) = i // 2
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = getattr(self, f"up_{i}_conv")(h)
            h = getattr(self, f"up_{i}_block")(h)
        return self.out(F.silu(self.norm_out(h)))


class KLVAE(nn.Module):
    """:meth:`encode` → (mean, clipped log-variance); :meth:`decode` →
    image. Latents are scaled by ``scaling_factor`` for the denoiser."""

    def __init__(self, ch: int = 64, ch_mults: Sequence[int] = (1, 2, 4),
                 latent_channels: int = 16, out_channels: int = 3,
                 scaling_factor: float = 0.5):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(ch, ch_mults, latent_channels)
        self.decoder = Decoder(ch, ch_mults, out_channels, latent_channels)

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions."""
        return init_like_flax(self, generator)

    def encode(self, x):
        with full_float32_convs():
            mean, logvar = self.encoder(x).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        with full_float32_convs():
            return self.decoder(z)
