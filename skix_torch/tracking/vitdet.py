"""ViT-Det backbone with windowed attention + SimpleFPN neck.

Port of ``skix/tracking/vitdet.py`` with ``window_flash=True``:

- the 72×72 grid (1008 px, patch 14) splits into 3×3 windows of 24²
  tokens; every window block attends through the single-tile kernel (K2,
  block == ws²) with the rope fused from tables on WINDOW-LOCAL
  coordinates (the rope's logits depend only on coordinate differences, so
  local coordinates give the global-coordinate result); the global blocks
  (7, 15, 23, 31) go through K1 with tables on the global grid;
- the rope is skix's own (``rope_style="skix"``, the default: rope_2d,
  y then x, rotate-half, freq ``rope_freq``) or the reference SAM3
  ViT-Det's (``rope_style="sam3"``, which converted SAM3 weights need:
  :func:`axial_rope_angles`, x then y, theta 10000, interleaved pairs).
  skix sends the sam3 rope through an ``attn_fn``
  (``_sam3_rope_attention``); here it is a
  :class:`~skix_torch.ops.attention.RopeTables` of style
  ``"interleaved"`` that the blocks pass to K1/K2 (K3/K4/K5 in the
  backward), with no rope_2d on top (skix's ``rope_freq=-1``);
- ``pretrain_img_size`` sizes the absolute position table (336 px → a
  24×24 table tiled 3×3 over the 72×72 grid);
  :func:`convert_vitdet_state_dict` reads a reference SAM3 ViT-Det state
  dict into this module;
- the SimpleFPN neck hangs four scale branches (4×, 2×, 1×, 0.5×) off the
  last trunk feature, each ending in 1×1 + 3×3 convs to ``d_model``, with
  sine-cosine position maps.

The trunk trains: window partition and unpartition are reshapes and
permutes (differentiable), and the attention kernels have their backward
(K5 for the windows, K3/K4 for the global blocks). ``remat=True`` wraps each
block in ``torch.utils.checkpoint`` (skix's ``nn.remat``): its activations
are recomputed in the backward, so its forward kernels launch twice. It is
off by default, as in skix.

The XLA-attention A/B path (``window_flash=False``) raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skix_torch.models.layers import (Block, Conv, ConvTranspose, LayerNorm,
                                      PatchEmbed, make_grid_positions)
from skix_torch.ops.attention import (RopeTables, interleaved_rope_tables,
                                      rope_2d_tables)


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
                 remat: bool = False, window_flash: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if rope_style not in ("skix", "sam3"):
            raise ValueError(f"rope_style {rope_style!r}: 'skix' or 'sam3'")
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
        self.rope_style = rope_style
        self.global_att_blocks = tuple(global_att_blocks)
        self.remat = remat
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
        if self.rope_style == "sam3":
            rope_glob = _sam3_rope_tables(gh, gw, hd, dev)
            rope_win = _sam3_rope_tables(ws, ws, hd, dev)
        else:
            rope_glob = _grid_rope_tables(gh, gw, hd, self.rope_freq, dev)
            rope_win = _grid_rope_tables(ws, ws, hd, self.rope_freq, dev)
        glob = set(self.global_att_blocks)
        for i in range(self.depth):
            blk = getattr(self, f"block_{i}")
            if self.remat and torch.is_grad_enabled():
                blk = functools.partial(checkpoint, blk, use_reentrant=False)
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
    return RopeTables(*rope_2d_tables(torch.as_tensor(
        make_grid_positions(gh, gw), device=device), hd, freq))


def axial_rope_angles(gh: int, gw: int, head_dim: int,
                      theta: float = 10000.0,
                      scale_pos: float = 1.0) -> np.ndarray:
    """The reference ViT-Det's rope angles (``compute_axial_cis``): token
    t at (x = t % gw, y = t // gw); the first head_dim/4 pairs rotate by
    x·freqs, the next head_dim/4 by y·freqs. ``(gh·gw, head_dim/2)``
    float32 angles, one per interleaved pair."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4)[: head_dim // 4]
                             / head_dim))
    t = np.arange(gh * gw, dtype=np.float32)
    t_x = (t % gw) * scale_pos
    t_y = (t // gw) * scale_pos
    ang_x = np.outer(t_x, freqs)
    ang_y = np.outer(t_y, freqs)
    return np.concatenate([ang_x, ang_y], axis=-1).astype(np.float32)


def apply_rope_interleaved(x, angles):
    """The reference's rotation of interleaved pairs, ``x (..., N, D)``
    viewed as ``(..., N, D/2, 2)`` (``apply_rotary_enc``), in plain torch:
    what the fused tables of :func:`_sam3_rope_tables` compute."""
    shape = x.shape
    xr = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    a, b = xr[..., 0], xr[..., 1]
    cos, sin = torch.cos(angles), torch.sin(angles)
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return out.reshape(shape).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _sam3_rope_tables(gh: int, gw: int, hd: int, device):
    """The sam3 rope of a gh × gw grid on ``device`` as interleaved-style
    tables (skix's ``_sam3_rope_attention``), built once per layout."""
    angles = torch.as_tensor(axial_rope_angles(gh, gw, hd), device=device)
    return RopeTables(*interleaved_rope_tables(angles), "interleaved")


def convert_vitdet_state_dict(sd) -> dict[str, torch.Tensor]:
    """A reference SAM3 ViT-Det state dict (``patch_embed.proj.*``,
    ``pos_embed``, ``ln_pre.*``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,
    norm2,mlp.fc1,mlp.fc2}.*``) → this module's ``state_dict``, reading
    the keys skix's ``convert_vitdet_state_dict`` reads. Use with
    ``rope_style="sam3"``, the reference's ``pretrain_img_size`` and
    ``ln_pre``. The sequence ``pos_embed`` loses its cls entry when it has
    one and becomes the (1, side, side, C) table; a reference without a
    patch bias gets a zero one; the rope has no weights. Torch layouts
    are the port's, so every other tensor is copied under its name."""
    def t(x):
        return torch.as_tensor(np.asarray(
            x.detach().cpu().numpy() if hasattr(x, "detach") else x,
            np.float32))

    w = t(sd["patch_embed.proj.weight"])            # (C, 3, p, p)
    out = {"patch_embed.proj.weight": w,
           "patch_embed.proj.bias": (t(sd["patch_embed.proj.bias"])
                                     if "patch_embed.proj.bias" in sd
                                     else torch.zeros(w.shape[0]))}
    pos = t(sd["pos_embed"])                        # (1, P(+1), C)
    side = math.isqrt(pos.shape[1])
    if side * side != pos.shape[1]:                 # a cls entry: drop it
        pos = pos[:, 1:]
        side = math.isqrt(pos.shape[1])
    out["pos_embed"] = pos.reshape(1, side, side, -1)
    if "ln_pre.weight" in sd:
        out["ln_pre.weight"] = t(sd["ln_pre.weight"])
        out["ln_pre.bias"] = t(sd["ln_pre.bias"])
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                     "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"block_{i}.{name}.{leaf}"] = t(
                    sd[f"blocks.{i}.{name}.{leaf}"])
        i += 1
    return out


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
