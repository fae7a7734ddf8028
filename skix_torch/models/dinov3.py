"""DINOv3-shaped ViT trunk (axial RoPE, storage tokens) and its hub converter.

Port of ``skix/models/dinov3.py``: the published DINOv3 architecture (a ViT
trunk whose learned positions are replaced by axial 2D RoPE on the PATCH
tokens only; a cls token and ``n_storage_tokens`` register-style tokens
prepend the sequence and skip the rope; pre-LN blocks with LayerScale; Mlp
or gated-SiLU FFN), the variant table of the reference's factory names, and
``convert_dinov3_trunk``, which maps a facebookresearch/dinov3 hub
``state_dict`` onto skix's variables tree (numpy only; the bridge
``skix_torch.convert`` takes that tree to this module).

skix ropes the patch rows and computes attention with einsums. The port
computes the same function through ``flash_attention`` (K1 on the card)
with rope tables ``(S, head_dim)``: the prefix rows are the identity (cos
1, sin 0), so the rope pass leaves them exactly as they are, and the patch
rows hold skix's angles. skix's rotate-half over the whole head is the
kernels' ``("segments", (head_dim,))`` style (one segment; the kernels'
``"half"`` style is VGGT's rotate-half within each half). Both tables are
pair-symmetric, so the backward's un-rotation is exact.

RoPE (DINOv3 RopePositionEmbedding): patch-center coordinates normalized
to [-1, 1] per axis ("separate"; "min"/"max" divide both axes by the
shorter/longer side), head_dim/4 periods per axis (geometric in ``base``,
or log-spaced in [min_period, max_period]), angles ``2π·coord/period`` for
(h, w) concatenated, then duplicated for the rotate-half convention.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Dense, LayerNorm, LayerScale, PatchConv,
                                      init_like_flax)
from skix_torch.ops.attention import flash_attention
from skix_torch.utils.device import constant


def dinov3_rope_periods(head_dim: int, base: Optional[float] = 100.0,
                        min_period: Optional[float] = None,
                        max_period: Optional[float] = None) -> np.ndarray:
    """(head_dim/4,) rotation periods: geometric in ``base`` or log-spaced
    between ``min_period`` and ``max_period``."""
    if head_dim % 4:
        raise ValueError("head_dim must be a multiple of 4 for 2D RoPE")
    n = head_dim // 4
    if min_period is not None and max_period is not None:
        exponents = np.linspace(0.0, 1.0, n)
        return (min_period
                * (max_period / min_period) ** exponents).astype(np.float32)
    if base is None:
        raise ValueError("need base or (min_period, max_period)")
    return (base ** (2.0 * np.arange(n) / (2 * n))).astype(np.float32)


def dinov3_rope_coords(gh: int, gw: int, normalize_coords: str = "separate"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened patch-center coordinates in [-1, 1]: ``(hh, ww)`` each
    (gh·gw,)."""
    if normalize_coords == "separate":
        ch = (np.arange(gh) + 0.5) / gh
        cw = (np.arange(gw) + 0.5) / gw
    elif normalize_coords == "max":
        s = max(gh, gw)
        ch = (np.arange(gh) + 0.5) / s
        cw = (np.arange(gw) + 0.5) / s
    elif normalize_coords == "min":
        s = min(gh, gw)
        ch = (np.arange(gh) + 0.5) / s
        cw = (np.arange(gw) + 0.5) / s
    else:
        raise ValueError(f"unknown normalize_coords {normalize_coords!r}")
    ch = 2.0 * ch - 1.0
    cw = 2.0 * cw - 1.0
    return (np.repeat(ch, gw).astype(np.float32),
            np.tile(cw, gh).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _coords(gh: int, gw: int, normalize_coords: str):
    """:func:`dinov3_rope_coords`, one pair of arrays per grid (kept on the
    device by ``constant``)."""
    return dinov3_rope_coords(gh, gw, normalize_coords)


def rope_tables_with_prefix(periods: torch.Tensor, gh: int, gw: int,
                            n_prefix: int,
                            normalize_coords: str = "separate"):
    """Full-sequence ``(cos, sin)`` tables ``(n_prefix + gh·gw, head_dim)``
    float32 on ``periods``' device for ``flash_attention`` with
    ``rope_rotate=("segments", (head_dim,))``: identity rows (cos 1, sin 0)
    for the prefix tokens, then skix's angles ``2π·coord/period`` of the
    patch rows, h and w concatenated and tiled twice."""
    dev = periods.device
    hh, ww = (constant(c, dev)[:, None]
              for c in _coords(gh, gw, normalize_coords))
    periods = periods.to(torch.float32)[None, :]
    ang = torch.cat([2.0 * math.pi * hh / periods,
                     2.0 * math.pi * ww / periods], dim=-1)
    ang = torch.cat([ang, ang], dim=-1)                     # (N, hd)
    hd = ang.shape[-1]
    one = torch.ones((n_prefix, hd), device=dev)
    zero = torch.zeros((n_prefix, hd), device=dev)
    return (torch.cat([one, torch.cos(ang)]),
            torch.cat([zero, torch.sin(ang)]))


class Dinov3Attention(nn.Module):
    """Self-attention with RoPE on the patch tokens only (the prefix rows of
    the tables are the identity)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x, cos, sin):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = flash_attention(q, k, v, rope_cos=cos, rope_sin=sin,
                              rope_rotate=("segments", (hd,)))
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class GatedFFN(nn.Module):
    """DINOv3's gated-SiLU FFN: ``w3(silu(w1·x) * (w2·x))``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = Dense(dim, hidden)
        self.w2 = Dense(dim, hidden)
        self.w3 = Dense(hidden, dim)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


class Dinov3Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ffn: str = "mlp", ffn_hidden: Optional[int] = None,
                 ln_eps: float = 1e-6, init_values: float = 1e-5):
        super().__init__()
        hidden = ffn_hidden if ffn_hidden is not None else int(dim * mlp_ratio)
        self.ffn = ffn
        self.norm1 = LayerNorm(dim, ln_eps)
        self.attn = Dinov3Attention(dim, num_heads)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = LayerNorm(dim, ln_eps)
        if ffn == "swiglu":
            self.mlp = GatedFFN(dim, hidden)
        else:
            self.mlp_fc1 = Dense(dim, hidden)
            self.mlp_fc2 = Dense(hidden, dim)
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x, cos, sin):
        x = x + self.ls1(self.attn(self.norm1(x), cos, sin))
        h = self.norm2(x)
        if self.ffn == "swiglu":
            h = self.mlp(h)
        else:
            h = self.mlp_fc2(F.gelu(self.mlp_fc1(h)))
        return x + self.ls2(h)


class Dinov3Trunk(nn.Module):
    """DINOv3-shaped encoder → final-layer NORMALIZED patch tokens (B,
    gh·gw, C). ``rope_periods`` is a buffer (the hub serializes it), so a
    converted checkpoint restores it exactly; it takes no gradient."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6,
                 n_storage_tokens: int = 4, mlp_ratio: float = 4.0,
                 ffn: str = "mlp", ffn_hidden: Optional[int] = None,
                 rope_base: Optional[float] = 100.0,
                 rope_min_period: Optional[float] = None,
                 rope_max_period: Optional[float] = None,
                 rope_normalize: str = "separate", ln_eps: float = 1e-6):
        super().__init__()
        self.patch_size = patch_size
        self.depth = depth
        self.n_storage_tokens = n_storage_tokens
        self.rope_normalize = rope_normalize
        self.patch_embed = PatchConv(3, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.storage_tokens = nn.Parameter(
            torch.zeros(1, n_storage_tokens, embed_dim))
        self.register_buffer("rope_periods", torch.as_tensor(
            dinov3_rope_periods(embed_dim // num_heads, rope_base,
                                rope_min_period, rope_max_period)))
        for i in range(depth):
            setattr(self, f"block_{i}", Dinov3Block(
                embed_dim, num_heads, mlp_ratio, ffn, ffn_hidden, ln_eps))
        self.norm = LayerNorm(embed_dim, ln_eps)

    def init_weights(self, generator=None):
        """flax's initializers: LeCun-normal kernels, zero tokens, LayerScale
        1e-5; the periods keep their formula."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.cls_token.zero_()
            self.storage_tokens.zero_()
            for m in self.modules():
                if isinstance(m, LayerScale):
                    m.gamma.fill_(1e-5)
        return self

    def forward(self, images):
        B, H, W, _ = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed(images).reshape(B, gh * gw, -1)
        C = x.shape[-1]
        n_prefix = 1 + self.n_storage_tokens
        x = torch.cat([self.cls_token.expand(B, 1, C),
                       self.storage_tokens.expand(B, self.n_storage_tokens, C),
                       x], dim=1)
        cos, sin = rope_tables_with_prefix(self.rope_periods, gh, gw,
                                           n_prefix, self.rope_normalize)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, cos, sin)
        return self.norm(x)[:, n_prefix:]


# ---------------------------------------------------------------------------
# hub converter (numpy only)
# ---------------------------------------------------------------------------
def _np_of(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t)


# the reference factory names → published architecture hyperparameters;
# ``ffn_hidden`` where the hub variant rounds the SwiGLU width
DINOV3_VARIANTS = {
    "dinov3_vits16": dict(embed_dim=384, depth=12, num_heads=6,
                          ffn="mlp", n_storage_tokens=4),
    "dinov3_vits16plus": dict(embed_dim=384, depth=12, num_heads=6,
                              ffn="swiglu", n_storage_tokens=4),
    "dinov3_vitb16": dict(embed_dim=768, depth=12, num_heads=12,
                          ffn="mlp", n_storage_tokens=4),
    "dinov3_vitl16": dict(embed_dim=1024, depth=24, num_heads=16,
                          ffn="mlp", n_storage_tokens=4),
    "dinov3_vith16plus": dict(embed_dim=1280, depth=32, num_heads=20,
                              ffn="swiglu", n_storage_tokens=4),
    "dinov3_vit7b16": dict(embed_dim=4096, depth=40, num_heads=32,
                           ffn="swiglu", ffn_hidden=8192,
                           n_storage_tokens=4,
                           rope_base=None, rope_min_period=0.5,
                           rope_max_period=90.0),
}


def _strip_encoder(state_dict) -> dict:
    return {(k[len("encoder."):] if k.startswith("encoder.") else k): v
            for k, v in state_dict.items()}


def infer_dinov3_config(state_dict) -> dict:
    """:class:`Dinov3Trunk` keyword arguments from a hub state dict's shapes
    (embed_dim, depth, ffn, ffn_hidden, n_storage_tokens, patch_size, and
    num_heads from the serialized periods: head_dim = 4·len(periods))."""
    sd = _strip_encoder(state_dict)
    embed_dim = int(_np_of(sd["cls_token"]).shape[-1])
    cfg = {
        "embed_dim": embed_dim,
        "n_storage_tokens": int(_np_of(sd["storage_tokens"]).shape[1]),
        "patch_size": int(_np_of(sd["patch_embed.proj.weight"]).shape[-1]),
        "depth": 1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("blocks.")),
    }
    if "blocks.0.mlp.w1.weight" in sd:
        cfg["ffn"] = "swiglu"
        cfg["ffn_hidden"] = int(_np_of(sd["blocks.0.mlp.w1.weight"]).shape[0])
    else:
        cfg["ffn"] = "mlp"
        cfg["ffn_hidden"] = int(_np_of(sd["blocks.0.mlp.fc1.weight"]).shape[0])
    if "rope_embed.periods" in sd:
        head_dim = 4 * int(_np_of(sd["rope_embed.periods"]).shape[0])
        cfg["num_heads"] = embed_dim // head_dim
    return cfg


def convert_dinov3_trunk(state_dict, ffn: str = "mlp",
                         head_dim: Optional[int] = None) -> dict:
    """facebookresearch/dinov3 hub ``state_dict()`` → skix's variables tree
    ``{"params": ...}`` for the trunk (numpy arrays; an ``encoder.`` prefix,
    as the reference wraps the hub model, is accepted). Load it into
    :class:`Dinov3Trunk` with ``skix_torch.convert.flax_to_state_dict``."""
    sd = _strip_encoder(state_dict)

    def dense(pre):
        return {"kernel": _np_of(sd[f"{pre}.weight"]).T,
                "bias": _np_of(sd[f"{pre}.bias"])}

    def ln(pre):
        return {"scale": _np_of(sd[f"{pre}.weight"]),
                "bias": _np_of(sd[f"{pre}.bias"])}

    p: dict = {
        "patch_embed": {
            "kernel": _np_of(sd["patch_embed.proj.weight"]).transpose(
                2, 3, 1, 0),
            "bias": _np_of(sd["patch_embed.proj.bias"])},
        "cls_token": _np_of(sd["cls_token"]),
        "storage_tokens": _np_of(sd["storage_tokens"]),
        "norm": ln("norm"),
    }
    if "rope_embed.periods" in sd:
        p["rope_periods"] = _np_of(sd["rope_embed.periods"])
    else:  # buffer serialized non-persistently → recompute from base
        if head_dim is None:
            raise ValueError("state dict has no rope_embed.periods — "
                             "pass head_dim to recompute the default "
                             "base-100 periods")
        p["rope_periods"] = dinov3_rope_periods(head_dim)
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        pre = f"blocks.{i}"
        blk = {
            "norm1": ln(f"{pre}.norm1"),
            "norm2": ln(f"{pre}.norm2"),
            "attn": {"qkv": dense(f"{pre}.attn.qkv"),
                     "proj": dense(f"{pre}.attn.proj")},
            "ls1": {"gamma": _np_of(sd[f"{pre}.ls1.gamma"])},
            "ls2": {"gamma": _np_of(sd[f"{pre}.ls2.gamma"])},
        }
        if ffn == "swiglu":
            blk["mlp"] = {"w1": dense(f"{pre}.mlp.w1"),
                          "w2": dense(f"{pre}.mlp.w2"),
                          "w3": dense(f"{pre}.mlp.w3")}
        else:
            blk["mlp_fc1"] = dense(f"{pre}.mlp.fc1")
            blk["mlp_fc2"] = dense(f"{pre}.mlp.fc2")
        p[f"block_{i}"] = blk
        i += 1
    return {"params": p}
