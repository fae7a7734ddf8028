"""ViT-Det backbone with windowed attention + SimpleFPN neck.

Port of ``skix/tracking/vitdet.py`` with ``rope_style="skix"`` and
``window_flash=True``, the stage's defaults:

- the 72×72 grid (1008 px, patch 14) splits into 3×3 windows of 24²
  tokens; every window block attends through the single-tile kernel (K2,
  block == ws²) with the 2D rope fused from tables on WINDOW-LOCAL
  coordinates (the rope's logits depend only on coordinate differences, so
  local coordinates give the global-coordinate result); the global blocks
  (7, 15, 23, 31) go through K1 with tables on the global grid;
- the SimpleFPN neck hangs four scale branches (4×, 2×, 1×, 0.5×) off the
  last trunk feature, each ending in 1×1 + 3×3 convs to ``d_model``, with
  sine-cosine position maps.

The reference's interleaved axial rope (``rope_style="sam3"``), which only
converted SAM3 weights need, and the XLA-attention A/B path
(``window_flash=False``) raise.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Block, Conv, ConvTranspose, LayerNorm,
                                      PatchEmbed, make_grid_positions)
from skix_torch.ops.attention import rope_2d_tables

_INTERLEAVED_ROPE_SLICE = ("the interleaved-rope slice of the port (K1's "
                           "interleaved rope, for converted SAM3 weights)")


def window_partition(x, window_size: int):
    """(B, H, W, C) → (B·nw, ws², C) + padded (Hp, Wp)."""
    B, H, W, C = x.shape
    ph, pw = (-H) % window_size, (-W) % window_size
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size,
                  window_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size, C)
    return x, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    nh, nw = Hp // window_size, Wp // window_size
    B = windows.shape[0] // (nh * nw)
    x = windows.reshape(B, nh, nw, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class ViTDetBackbone(nn.Module):
    """Windowed ViT trunk: ``images (B, H, W, 3)`` normalized →
    ``(B, gh, gw, C)`` float32."""

    def __init__(self, img_size: int = 1008, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: float = 4.625, window_size: int = 24,
                 global_att_blocks: Sequence[int] = (7, 15, 23, 31),
                 rope_freq: float = 100.0, rope_style: str = "skix",
                 pretrain_img_size: Optional[int] = None, ln_pre: bool = True,
                 window_flash: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if rope_style != "skix":
            raise NotImplementedError(
                f"rope_style={rope_style!r} comes with "
                f"{_INTERLEAVED_ROPE_SLICE}; 'skix' is ported")
        if not window_flash:
            raise NotImplementedError(
                "window_flash=False (XLA window attention, an A/B option of "
                "skix) is not ported: windows go through the single-tile "
                "kernel")
        hd = embed_dim // num_heads
        if hd % 4:
            raise ValueError(f"head dim {hd}: the fused rope tables need a "
                             "multiple of 4")
        self.img_size, self.patch_size = img_size, patch_size
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.window_size, self.rope_freq = window_size, rope_freq
        self.global_att_blocks = tuple(global_att_blocks)
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        base = (pretrain_img_size or img_size) // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, base, base, embed_dim))
        self.ln_pre = LayerNorm(embed_dim, 1e-5, dtype) if ln_pre else None
        glob = set(self.global_att_blocks)
        for i in range(depth):
            self.add_module(f"block_{i}", Block(
                embed_dim, num_heads, mlp_ratio, qk_norm=False, dtype=dtype,
                attn_block=None if i in glob else window_size ** 2))
        self.depth = depth

    def forward(self, images):
        B, H, W, _ = images.shape
        p, C = self.patch_size, self.embed_dim
        gh, gw = H // p, W // p
        x = self.patch_embed(images.to(self.dtype))
        base = self.pos_embed.shape[1]
        pos = self.pos_embed.tile(1, -(-gh // base), -(-gw // base), 1)
        x = x.reshape(B, gh, gw, C) + pos[:, :gh, :gw].to(self.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        hd, ws, dev = C // self.num_heads, self.window_size, images.device
        rope_glob = _grid_rope_tables(gh, gw, hd, self.rope_freq, dev)
        rope_win = _grid_rope_tables(ws, ws, hd, self.rope_freq, dev)
        glob = set(self.global_att_blocks)
        for i in range(self.depth):
            blk = getattr(self, f"block_{i}")
            if i in glob:
                t = blk(x.reshape(B, gh * gw, C), rope_glob)
                x = t.reshape(B, gh, gw, C)
            else:
                wins, pad_hw = window_partition(x, ws)
                x = window_unpartition(blk(wins, rope_win), ws, pad_hw,
                                       (gh, gw))
        return x.to(torch.float32)


@functools.lru_cache(maxsize=16)
def _grid_rope_tables(gh: int, gw: int, hd: int, freq: float, device):
    """The rope tables of a gh × gw grid on ``device``, built once per
    layout (skix builds them while tracing)."""
    return rope_2d_tables(torch.as_tensor(make_grid_positions(gh, gw),
                                          device=device), hd, freq)


@functools.lru_cache(maxsize=16)
def _position_map(gh: int, gw: int, dim: int, device) -> torch.Tensor:
    """:func:`sincos_position_map` on ``device``, built once per shape: at
    1008 px the four levels are 28M sines and cosines, about half a second
    of host time if made for every frame."""
    return torch.as_tensor(sincos_position_map(gh, gw, dim), device=device)


def sincos_position_map(gh: int, gw: int, dim: int,
                        temperature: float = 10000.0) -> np.ndarray:
    """(gh, gw, dim) sine-cosine 2D position encoding (DETR convention)."""
    half = dim // 2
    ys, xs = np.meshgrid(np.arange(gh, dtype=np.float32) + 0.5,
                         np.arange(gw, dtype=np.float32) + 0.5,
                         indexing="ij")
    dim_t = temperature ** (2 * (np.arange(half // 2)) / half)

    def enc(v):
        f = v[..., None] / dim_t
        return np.stack([np.sin(f), np.cos(f)], -1).reshape(*v.shape, -1)

    return np.concatenate([enc(ys), enc(xs)], axis=-1).astype(np.float32)


class SimpleFPNNeck(nn.Module):
    """Final trunk feature → 4 projected scale levels + sine positions."""

    def __init__(self, in_dim: int, d_model: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        for si, scale in enumerate(self.scale_factors):
            c = in_dim
            if scale == 4.0:
                self.add_module(f"s{si}_dconv0",
                                ConvTranspose(in_dim, in_dim // 2))
                self.add_module(f"s{si}_dconv1",
                                ConvTranspose(in_dim // 2, in_dim // 4))
                c = in_dim // 4
            elif scale == 2.0:
                self.add_module(f"s{si}_dconv0",
                                ConvTranspose(in_dim, in_dim // 2))
                c = in_dim // 2
            elif scale not in (1.0, 0.5):
                raise NotImplementedError(f"scale {scale}")
            self.add_module(f"s{si}_conv1x1", Conv(c, d_model, 1))
            self.add_module(f"s{si}_conv3x3", Conv(d_model, d_model, 3))

    def forward(self, feat):
        """``feat (B, gh, gw, C)`` → (features [(B, h, w, d_model)...],
        positions [(h, w, d_model)...]) ordered per ``scale_factors``."""
        outs, poss = [], []
        for si, scale in enumerate(self.scale_factors):
            x = feat
            if scale == 4.0:
                x = F.gelu(getattr(self, f"s{si}_dconv0")(x))
                x = getattr(self, f"s{si}_dconv1")(x)
            elif scale == 2.0:
                x = getattr(self, f"s{si}_dconv0")(x)
            elif scale == 0.5:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            x = getattr(self, f"s{si}_conv3x3")(getattr(self, f"s{si}_conv1x1")(x))
            outs.append(x.to(torch.float32))
            poss.append(_position_map(x.shape[1], x.shape[2], x.shape[3],
                                      x.device))
        return outs, poss
