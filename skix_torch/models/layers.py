"""Transformer and convolution building blocks shared by the port's models.

Port of ``skix/models/layers.py``: pre-LN ``Block`` with LayerScale, QK-norm
and 2D rope, ``Mlp``, ``PatchEmbed`` and the 2D rope itself; plus the flax
layers the SAM3 front path needs (``Conv`` with flax's ``SAME`` padding,
``ConvTranspose``, ``GroupNorm``); ``PatchConv`` (a flax ``Conv`` whose
kernel equals its stride, as one product) and the DINOv2-shaped
``VisionTransformer`` of the side-view models. Submodules
carry the flax names (``attn.qkv``, ``q_norm``, ``ls1.gamma``, …), so
``skix_torch.convert`` maps a skix variables tree onto them leaf by leaf.

Flax's ``dtype`` semantics are kept. Parameters are float32; a ``Dense``
or ``PatchEmbed`` with ``dtype=bfloat16`` casts its input and weights to
bf16 and returns bf16 (:func:`cast_to_compute_dtype` stores those
weights in bf16 once, with the same values). ``LayerNorm`` computes its
statistics in f32 as E[x²] − E[x]² and returns ``dtype`` (or f32 when
``dtype`` is None). ``LayerScale`` multiplies by an f32 gamma, so a bf16
branch re-enters an f32 residual stream, as in the flax blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.ops.attention import RopeTables, flash_attention


# --------------------------------------------------------------------------
# 2D rotary position embedding
# --------------------------------------------------------------------------
def make_grid_positions(h: int, w: int) -> np.ndarray:
    """(h·w, 2) array of (y, x) patch coordinates."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ys.ravel(), xs.ravel()], axis=-1).astype(np.int32)


def _rope_1d(x, positions, base_freq: float):
    """1D rotary embedding on ``x (..., N, d)`` with integer ``positions
    (..., N)``, rotate-half convention."""
    d = x.shape[-1]
    exponents = torch.arange(0, d, 2, dtype=torch.float32,
                             device=x.device) / d
    inv_freq = 1.0 / (base_freq ** exponents)
    angles = positions[..., None].to(torch.float32) * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * torch.cos(angles).to(x.dtype) + rotated * torch.sin(angles).to(x.dtype)


def rope_2d(x, pos, base_freq: float = 100.0):
    """2D rope: ``x (B, H, N, D)``, ``pos (B, N, 2)`` (y, x) integer coords;
    y rotates the first D/2 features, x the second D/2. The model applies
    it through the attention kernel's tables
    (:func:`skix_torch.ops.attention.rope_2d_tables`), which equal it."""
    half = x.shape[-1] // 2
    out_y = _rope_1d(x[..., :half], pos[..., 0][:, None, :], base_freq)
    out_x = _rope_1d(x[..., half:], pos[..., 1][:, None, :], base_freq)
    return torch.cat([out_y, out_x], dim=-1)


# --------------------------------------------------------------------------
# flax-semantics layers
# --------------------------------------------------------------------------
class Dense(nn.Linear):
    """``flax.linen.Dense``: input, weight and bias cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis: f32 statistics with
    var = max(E[x²] − E[x]², 0), output cast to ``dtype`` (None → f32)."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 use_scale: bool = True, use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype or torch.float32)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, bias, dtype)
        self.fc2 = Dense(hidden_features, out_features or in_features, bias,
                         dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))     # erf GELU


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma


class MultiHeadAttention(nn.Module):
    """Self-attention with optional QK-LayerNorm; the core runs through
    :func:`skix_torch.ops.attention.flash_attention`. ``rope`` is a
    :class:`~skix_torch.ops.attention.RopeTables` (or a ``(cos, sin)``
    pair, style rotate-half) of (N, head_dim) tables shared by every batch
    row (the VGGT layouts, the ViT-Det window-local and global grids): the
    kernel applies it to q and k in its style (skix passes the
    interleaved style through an ``attn_fn``; the port passes it with the
    tables). ``attn_block`` is skix's explicit tile
    edge: a sequence of exactly that length is one tile, which sends the
    call to the single-tile kernel (K2)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 ln_eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 attn_fixed_max: Optional[float] = None,
                 attn_block: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_fixed_max = attn_fixed_max
        self.attn_block = attn_block
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype)
        if qk_norm:
            self.q_norm = LayerNorm(hd, ln_eps, dtype)
            self.k_norm = LayerNorm(hd, ln_eps, dtype)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Dense(dim, dim, proj_bias, dtype)

    def forward(self, x, rope=None):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        cos, sin, rotate = (RopeTables(*rope) if rope is not None
                            else RopeTables(None, None))
        blk = self.attn_block
        out = flash_attention(q, k, v, fixed_max=self.attn_fixed_max,
                              rope_cos=cos, rope_sin=sin, block_q=blk,
                              block_k_major=blk, block_k=blk,
                              rope_rotate=rotate)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    """Pre-LN transformer block with LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 ffn_bias: bool = True, qk_norm: bool = False,
                 init_values: Optional[float] = None, ln_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 attn_fixed_max: Optional[float] = None,
                 attn_block: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_eps, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, qkv_bias, proj_bias,
                                       qk_norm, ln_eps, dtype, attn_fixed_max,
                                       attn_block)
        self.norm2 = LayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), bias=ffn_bias, dtype=dtype)
        if init_values:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x, rope=None):
        h = self.attn(self.norm1(x), rope)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h


class PatchEmbed(nn.Module):
    """Patchify ``(B, H, W, 3)`` → ``(B, h·w, C)``: the stride-p, p×p
    ``proj`` convolution, computed as one product of the (py, px, c)
    patch vectors with the flattened kernel (a plain float32 matmul on
    the card, where a float32 convolution would run in TF32)."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        h = _patch_product(x, self.proj.weight, self.proj.bias,
                           self.patch_size, self.dtype)
        return h.reshape(h.shape[0], -1, h.shape[-1])


def _patch_product(x, weight, bias, p: int, dtype=torch.float32):
    """A p×p, stride-p convolution of channels-last ``x (B, H, W, Cin)`` (an
    OIHW ``weight``) as one product of the (py, px, c) patch vectors with the
    flattened kernel: ``(B, H/p, W/p, O)``."""
    B, H, W, Cin = x.shape
    gh, gw = H // p, W // p
    patches = (x[:, :gh * p, :gw * p].reshape(B, gh, p, gw, p, Cin)
               .permute(0, 1, 3, 2, 4, 5).reshape(B, gh, gw, p * p * Cin))
    w = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    return F.linear(patches.to(dtype), w.to(dtype), bias.to(dtype))


class PatchConv(nn.Conv2d):
    """``flax.linen.Conv`` whose kernel equals its stride (``VALID``, or
    ``SAME`` on an input the stride divides, which pads nothing), on
    channels-last input ``(B, H, W, C)`` → ``(B, H/p, W/p, O)``; the weight
    is stored OIHW. Computed as one product (a full float32 matmul on the
    card, where cuDNN would take a float32 convolution in TF32)."""

    def __init__(self, in_features: int, out_features: int, patch: int):
        super().__init__(in_features, out_features, patch, stride=patch)

    def forward(self, x):
        return _patch_product(x, self.weight, self.bias, self.kernel_size[0])


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` on channels-last input ``(B, ..., C)``: f32
    statistics per (sample, group) over every non-batch axis, with
    var = max(E[x²] − E[x]², 0); f32 output."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps           # flax's default 1e-6
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xf = x.to(torch.float32).reshape(B, -1, G, C // G)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(x.shape) * self.weight + self.bias


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float, eps: float, dims):
    """flax ``BatchNorm`` in training: normalize ``x`` by its statistics over
    ``dims`` (the variance as flax's fast form, max(0, E[x²] − E[x]²),
    biased), ``(x − mean) · (rsqrt(var + eps) · weight) + bias`` in flax's
    order, and move the running statistics in place to ``momentum · old +
    (1 − momentum) · batch``. ``weight``, ``bias`` and the statistics are
    shaped to broadcast against ``x``'s reduced shape."""
    mean = x.mean(dims, keepdim=True)
    var = torch.clamp((x * x).mean(dims, keepdim=True) - mean * mean, min=0)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum)
                           * mean.detach().reshape(running_mean.shape))
        running_var.copy_(momentum * running_var + (1 - momentum)
                          * var.detach().reshape(running_var.shape))
    shape = mean.shape
    mul = torch.rsqrt(var + eps) * weight.reshape(shape)
    return (x - mean) * mul + bias.reshape(shape)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one axis: output ceil(n/s), the total
    pad split with the smaller half first (a stride-2 3×3 conv on an even
    axis pads (0, 1), not (1, 1))."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` on channels-last input ``(B, H, W, C)``: padding
    ``"SAME"`` (flax's asymmetric split), ``"VALID"`` or an int p (flax's
    explicit ``[(p, p), (p, p)]``), optional feature groups (depthwise),
    optional bias. The weight is stored OIHW, as the
    bridge converts flax's HWIO kernel. A 1×1 stride-1 conv runs as a
    matrix product."""

    def __init__(self, in_features: int, out_features: int, kernel_size=1,
                 stride=1, padding="SAME", groups: int = 1,
                 bias: bool = True):
        super().__init__(in_features, out_features, kernel_size, stride,
                         groups=groups, bias=bias)
        if padding not in ("SAME", "VALID") and not isinstance(padding, int):
            raise ValueError(f"padding {padding!r}: SAME, VALID or an int")
        self.same = padding == "SAME"
        self.explicit = padding if isinstance(padding, int) else 0

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        if kh == kw == sh == sw == 1 and self.groups == 1:
            return F.linear(x, self.weight[:, :, 0, 0], self.bias)
        xn = x.permute(0, 3, 1, 2)
        if self.same:
            ph = _same_pads(xn.shape[2], kh, sh)
            pw = _same_pads(xn.shape[3], kw, sw)
            xn = F.pad(xn, (*pw, *ph))
        y = F.conv2d(xn, self.weight, self.bias, self.stride, self.explicit,
                     1, self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Conv2d):
    """``flax.linen.ConvTranspose`` on channels-last input. With kernel ==
    stride (``SAME``, the default) every input pixel writes one k×k output
    patch. flax does not flip the kernel (``transpose_kernel=False``), so
    output offset ``a`` of a patch takes kernel tap ``k−1−a``: the weight
    (stored OIHW by the bridge's conv rule) is used flipped in space,
    computed as one f32 product, with no cuDNN convolution. With
    ``stride`` and a symmetric explicit ``padding`` p (flax's
    ``padding=[(p, p), (p, p)]``: the stride-dilated input padded by p and
    correlated with the kernel) it is torch's transposed convolution of
    the flipped kernel with padding k − 1 − p."""

    def __init__(self, in_features: int, out_features: int, kernel_size=2,
                 stride: Optional[int] = None, padding: Optional[int] = None):
        super().__init__(in_features, out_features, kernel_size,
                         stride=kernel_size if stride is None else stride)
        self.explicit = padding
        if padding is not None and padding > kernel_size - 1:
            raise ValueError(f"padding {padding} > kernel {kernel_size} - 1")

    def forward(self, x):
        kh, kw = self.kernel_size
        if self.explicit is not None:
            w = self.weight.transpose(0, 1).flip(2, 3)
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.bias,
                                   self.stride, kh - 1 - self.explicit)
            return y.permute(0, 2, 3, 1)
        B, h, w, _ = x.shape
        y = torch.einsum("bijc,ocuv->biujvo", x, self.weight.flip(2, 3))
        return y.reshape(B, h * kh, w * kw, -1) + self.bias


class VisionTransformer(nn.Module):
    """Plain ViT encoder with register tokens (port of skix's
    ``VisionTransformer``, DINOv2-shaped): ``patch_embed`` → ``[cls + pos₀,
    registers, patches + pos]`` → ``depth`` pre-LN blocks with LayerScale
    (LayerNorm eps 1e-6) → ``norm``; returns the normalized patch tokens
    (cls and registers stripped), and with ``taps`` also the patch tokens
    after each tapped block (unnormalized). The learned ``pos_embed`` (1, P
    + 1, C) is sized by ``num_patches``; ``forward`` takes another one of
    the input's grid (a resampled table) in its place. Attention runs
    through ``flash_attention`` (K1 on the card). With ``dtype=bfloat16``
    (VGGT's DINOv2 patch embed) the blocks compute in bf16 and the residual
    stream stays float32, as in flax: the bf16 patch tokens plus the f32
    position table are f32; the taps are float32, the output ``dtype``."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 num_register_tokens: int = 4, init_values: float = 1.0,
                 taps: Optional[tuple] = None, num_patches: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.init_values = init_values
        self.num_register_tokens = num_register_tokens
        self.taps = tuple(taps) if taps else None
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, num_register_tokens, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        for i in range(depth):
            setattr(self, f"block_{i}", Block(
                embed_dim, num_heads, mlp_ratio, init_values=init_values,
                ln_eps=1e-6, dtype=dtype))
        self.norm = LayerNorm(embed_dim, 1e-6, dtype)

    def init_weights(self, generator=None):
        """flax's initializers: LeCun-normal kernels, zero tokens, the
        position table N(0, 0.02²), LayerScale at ``init_values``."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.cls_token.zero_()
            self.register_tokens.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
            for m in self.modules():
                if isinstance(m, LayerScale):
                    m.gamma.fill_(self.init_values)
        return self

    def forward(self, images, pos_embed=None):
        x = self.patch_embed(images)
        B, _, C = x.shape
        pos = self.pos_embed if pos_embed is None else pos_embed
        x = x + pos[:, 1:]
        cls_t = (self.cls_token + pos[:, :1]).expand(B, 1, C)
        reg_t = self.register_tokens.expand(B, self.num_register_tokens, C)
        x = torch.cat([cls_t, reg_t, x], dim=1)
        n_prefix = 1 + self.num_register_tokens
        taps, want = [], set(self.taps or ())
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            if i in want:
                taps.append(x[:, n_prefix:].to(torch.float32))
        x = self.norm(x)
        if self.taps:
            return x[:, n_prefix:], taps
        return x[:, n_prefix:]


def cast_to_compute_dtype(module: nn.Module) -> nn.Module:
    """Store the weights of every ``Dense`` and ``PatchEmbed`` whose compute
    dtype is not float32 in that dtype. Their forward casts the weights to
    it anyway, so the outputs do not change; the weights take half the
    memory and are not cast again on every call."""
    for m in module.modules():
        target = m.proj if isinstance(m, PatchEmbed) else m
        if isinstance(m, (Dense, PatchEmbed)) and m.dtype != torch.float32:
            for name, prm in list(target.named_parameters(recurse=False)):
                prm.data = prm.data.to(m.dtype)
    return module


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None):
    """flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_like_flax(module: nn.Module, generator=None) -> nn.Module:
    """Re-initialize ``module`` with the distributions flax's ``init`` draws
    from (not its numbers): Dense and Conv kernels LeCun-normal, biases 0,
    LayerNorm scale 1 and bias 0. Model-specific parameters (tokens,
    LayerScale gammas) are set by the model's own ``init_weights``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                if m.weight is not None:
                    m.weight.fill_(1.0)
                if m.bias is not None:
                    m.bias.zero_()
    return module
