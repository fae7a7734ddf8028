"""VGGT point-track head (the reference's structure), PyTorch.

Port of ``skix/models/track_head.py``: a DPT feature extractor
(``feature_only``, ``down_ratio`` 2) feeding the CoTracker/VGGSfM
``BaseTrackerPredictor`` — a correlation pyramid (per-level 2×2 average
pool, dot-product correlation, zero-padded bilinear window samples), the
flow sin/cos embedding, a 2D sincos position table sampled at the query
points, the query/ref token, and the ``EfficientUpdateFormer`` alternating
time attention with virtual-track space attention. The CoTracker blocks'
pre-norm quirk (the residual stream keeps the NORMALIZED input) is kept.

Submodules carry skix's flax names, so ``skix_torch.convert`` maps a skix
variables tree onto them; ``models.vggt_convert.convert_track_head`` builds
that tree from a reference ``track_head.*`` state dict. Attention here is
skix's einsum + softmax (``torch.matmul``), float32, with no flash kernel:
skix sends none of these calls to Pallas. The tracker stays float32; on
the card its float32 products run in full float32 (PyTorch's default).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Dense, GroupNorm, LayerNorm, Mlp,
                                      init_like_flax)
from skix_torch.utils.device import constant


# --------------------------------------------------------------------------
# sampling helpers (grid_sample conventions: align_corners=True, pixels)
# --------------------------------------------------------------------------
def bilinear_sample(fmap: torch.Tensor, xy: torch.Tensor,
                    padding: str = "zeros") -> torch.Tensor:
    """``fmap (h, w, C)``, ``xy (..., 2)`` (x, y in feature coordinates) →
    ``(..., C)`` bilinear samples; ``"zeros"`` masks out-of-bounds taps,
    ``"border"`` clamps them."""
    h, w, _ = fmap.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(ix, iy):
        v = fmap[torch.clamp(iy, 0, h - 1).long(),
                 torch.clamp(ix, 0, w - 1).long()]
        if padding == "zeros":
            ok = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            v = v * ok[..., None]
        return v

    top = (tap(x0, y0) * (1 - wx)[..., None]
           + tap(x0 + 1, y0) * wx[..., None])
    bot = (tap(x0, y0 + 1) * (1 - wx)[..., None]
           + tap(x0 + 1, y0 + 1) * wx[..., None])
    return top * (1 - wy)[..., None] + bot * wy[..., None]


def _bilinear_zero_maps(maps: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``maps (..., H, W)`` scalar maps, ``xy (..., K, 2)`` (x, y) → ``(...,
    K)`` zero-padded bilinear samples, one map per leading index (the
    correlation window sampler). A size-1 axis collapses every coordinate
    to pixel 0, as grid_sample's normalize round trip does."""
    H, W = maps.shape[-2:]
    flat = maps.reshape(*maps.shape[:-2], H * W)
    x, y = xy[..., 0], xy[..., 1]
    if W == 1:
        x = torch.zeros_like(x)
    if H == 1:
        y = torch.zeros_like(y)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(ix, iy):
        ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = (torch.clamp(iy, 0, H - 1).long() * W
               + torch.clamp(ix, 0, W - 1).long())
        return torch.gather(flat, -1, idx) * ok

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def get_2d_embedding(xy: torch.Tensor, C: int) -> torch.Tensor:
    """Sin/cos flow embedding: interleaved sin/cos per axis at the
    increasing frequencies ``arange(0, C, 2) · 1000/C``; ``(..., 2C)``."""
    div = torch.as_tensor(np.arange(0, C, 2, dtype=np.float32) * (1000.0 / C),
                          device=xy.device)
    x = xy[..., 0:1] * div
    y = xy[..., 1:2] * div
    pe_x = torch.stack([torch.sin(x), torch.cos(x)], -1).reshape(
        *xy.shape[:-1], C)
    pe_y = torch.stack([torch.sin(y), torch.cos(y)], -1).reshape(
        *xy.shape[:-1], C)
    return torch.cat([pe_x, pe_y], dim=-1)


def sincos_pos_embed_2d(dim: int, hh: int, ww: int) -> np.ndarray:
    """2D sincos table ``(hh, ww, dim)``: the first half encodes the x
    (width) index, the second the y, each half [sin | cos] over
    ``ω_i = 10000^(-i/(dim/4))``."""
    half = dim // 2
    omega = 1.0 / 10000.0 ** (np.arange(half // 2, dtype=np.float64)
                              / (half / 2.0))
    gy, gx = np.meshgrid(np.arange(hh, dtype=np.float64),
                         np.arange(ww, dtype=np.float64), indexing="ij")

    def emb1d(pos):
        out = pos[..., None] * omega
        return np.concatenate([np.sin(out), np.cos(out)], axis=-1)

    return np.concatenate([emb1d(gx), emb1d(gy)], -1).astype(np.float32)


# --------------------------------------------------------------------------
# CoTracker transformer blocks
# --------------------------------------------------------------------------
class TorchMHA(nn.Module):
    """``torch.nn.MultiheadAttention``'s layout (packed ``in_proj`` and
    ``out_proj``) with skix's einsum/softmax attention; ``key_mask (B, Lk)``
    bool keeps False keys out of the softmax (their logits set to float32's
    lowest value, as skix does)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim)

    def forward(self, q_in, k_in, v_in, key_mask=None):
        C = q_in.shape[-1]
        Hh, hd = self.num_heads, C // self.num_heads
        W, b = self.in_proj_weight, self.in_proj_bias
        B, Lq, Lk = q_in.shape[0], q_in.shape[1], k_in.shape[1]
        q = F.linear(q_in, W[:C], b[:C]).reshape(B, Lq, Hh, hd).transpose(1, 2)
        k = F.linear(k_in, W[C:2 * C], b[C:2 * C]).reshape(
            B, Lk, Hh, hd).transpose(1, 2)
        v = F.linear(v_in, W[2 * C:], b[2 * C:]).reshape(
            B, Lk, Hh, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(hd))
        if key_mask is not None:
            logits = torch.where(key_mask[:, None, None, :], logits,
                                 torch.finfo(logits.dtype).min)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class AttnBlock(nn.Module):
    """Self-attention block; the residual stream keeps norm1(x)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn = TorchMHA(dim, num_heads)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = self.norm1(x)
        x = x + self.attn(x, x, x)
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    """Cross-attention block, the same residual quirk; ``norm_context``
    normalizes the context."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5)
        self.norm_context = LayerNorm(dim, 1e-5)
        self.cross_attn = TorchMHA(dim, num_heads)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, context, context_mask=None):
        x = self.norm1(x)
        ctx = self.norm_context(context)
        x = x + self.cross_attn(x, ctx, ctx, key_mask=context_mask)
        return x + self.mlp(self.norm2(x))


class EfficientUpdateFormer(nn.Module):
    """Track-update transformer: time attention per track, interleaved with
    virtual-track space attention (virtual ← point cross, virtual self,
    point ← virtual cross). ``x (B, N, T, input_dim)`` → ``(B, N, T,
    output_dim)``; ``valid (B, N)`` bool marks real tracks: the chunk pads
    are kept out of the virtual ← point attention, so they cannot move the
    real tracks."""

    def __init__(self, space_depth: int = 6, time_depth: int = 6,
                 input_dim: int = 388, hidden_size: int = 384,
                 num_heads: int = 8, output_dim: int = 130,
                 mlp_ratio: float = 4.0, add_space_attn: bool = True,
                 num_virtual_tracks: int = 64):
        super().__init__()
        self.space_depth, self.time_depth = space_depth, time_depth
        self.add_space_attn = add_space_attn
        self.num_virtual_tracks = num_virtual_tracks
        self.input_norm = LayerNorm(input_dim, 1e-5)
        self.input_transform = Dense(input_dim, hidden_size)
        if add_space_attn:
            # the reference parameter is spelled "virual_tracks"
            self.virual_tracks = nn.Parameter(
                torch.zeros(1, num_virtual_tracks, 1, hidden_size))
        for i in range(time_depth):
            setattr(self, f"time_blocks_{i}",
                    AttnBlock(hidden_size, num_heads, mlp_ratio))
        if add_space_attn:
            for j in range(space_depth):
                setattr(self, f"space_virtual_blocks_{j}",
                        AttnBlock(hidden_size, num_heads, mlp_ratio))
                setattr(self, f"space_point2virtual_blocks_{j}",
                        CrossAttnBlock(hidden_size, num_heads, mlp_ratio))
                setattr(self, f"space_virtual2point_blocks_{j}",
                        CrossAttnBlock(hidden_size, num_heads, mlp_ratio))
        self.output_norm = LayerNorm(hidden_size, 1e-5)
        self.flow_head = Dense(hidden_size, output_dim)

    def forward(self, x, valid=None):
        B, N0, T, _ = x.shape
        tokens = self.input_transform(self.input_norm(x))
        init_tokens = tokens
        nvt = self.num_virtual_tracks
        if self.add_space_attn:
            tokens = torch.cat([tokens, self.virual_tracks.expand(
                B, nvt, T, tokens.shape[-1])], dim=1)
        N = tokens.shape[1]
        j = 0
        for i in range(self.time_depth):
            tt = tokens.reshape(B * N, T, -1)
            tokens = getattr(self, f"time_blocks_{i}")(tt).reshape(B, N, T, -1)
            if self.add_space_attn and \
                    i % (self.time_depth // self.space_depth) == 0:
                st = tokens.transpose(1, 2).reshape(B * T, N, -1)
                pt, vt = st[:, :N - nvt], st[:, N - nvt:]
                pt_mask = None
                if valid is not None:
                    pt_mask = valid[:, None, :].expand(B, T, N0).reshape(
                        B * T, N0)
                vt = getattr(self, f"space_virtual2point_blocks_{j}")(
                    vt, pt, context_mask=pt_mask)
                vt = getattr(self, f"space_virtual_blocks_{j}")(vt)
                pt = getattr(self, f"space_point2virtual_blocks_{j}")(pt, vt)
                st = torch.cat([pt, vt], dim=1)
                tokens = st.reshape(B, T, N, -1).transpose(1, 2)
                j += 1
        if self.add_space_attn:
            tokens = tokens[:, :N - nvt]
        tokens = self.output_norm(tokens + init_tokens)
        return self.flow_head(tokens)


# --------------------------------------------------------------------------
# correlation pyramid
# --------------------------------------------------------------------------
def corr_pyramid_sample(fmaps, targets, coords, num_levels: int,
                        radius: int):
    """``fmaps (B, S, H, W, C)``, ``targets (B, S, N, C)``, ``coords (B, S,
    N, 2)`` level-0 feature coordinates → correlation windows ``(B, S, N,
    num_levels · (2r+1)²)``. Each level: 2×2 average pool, dot-product
    correlation / √C, zero-padded bilinear window sample at ``coords /
    2^level + Δ`` (Δ of meshgrid(d, d, "ij"), the axis-0 offset on x)."""
    d = np.arange(-radius, radius + 1, dtype=np.float32)
    dgrid = torch.as_tensor(
        np.stack(np.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2),
        device=coords.device)
    outs = []
    cur = fmaps
    for i in range(num_levels):
        B, S, H, W, C = cur.shape
        corr = torch.einsum("bsnc,bshwc->bsnhw", targets, cur) / float(
            np.sqrt(C))
        pts = coords[..., None, :] / (2.0 ** i) + dgrid
        outs.append(_bilinear_zero_maps(corr, pts))
        if i + 1 < num_levels:
            flat = cur.reshape(B * S, H, W, C).permute(0, 3, 1, 2)
            flat = F.avg_pool2d(flat, 2, 2).permute(0, 2, 3, 1)
            cur = flat.reshape(B, S, flat.shape[1], flat.shape[2], C)
    return torch.cat(outs, dim=-1)


# --------------------------------------------------------------------------
# tracker predictor
# --------------------------------------------------------------------------
class BaseTrackerPredictor(nn.Module):
    """Iterative track refinement: ``(query_points (B, N, 2) pixels, fmaps
    (B, S, HH, WW, C))`` → (coordinate predictions per iteration in pixels,
    vis (B, S, N), conf (B, S, N))."""

    def __init__(self, stride: int = 2, corr_levels: int = 7,
                 corr_radius: int = 4, latent_dim: int = 128,
                 hidden_size: int = 384, use_spaceatt: bool = True,
                 depth: int = 6, max_scale: int = 518,
                 predict_conf: bool = True, iters: int = 4):
        super().__init__()
        self.stride, self.corr_levels, self.corr_radius = (
            stride, corr_levels, corr_radius)
        self.latent_dim, self.max_scale, self.iters = latent_dim, max_scale, iters
        ld = latent_dim
        tdim = 3 * ld + 4
        self.fmap_norm = LayerNorm(ld, 1e-5)
        self.corr_mlp = Mlp(corr_levels * (2 * corr_radius + 1) ** 2,
                            hidden_size, out_features=ld)
        self.updateformer = EfficientUpdateFormer(
            space_depth=depth if use_spaceatt else 0, time_depth=depth,
            input_dim=tdim, hidden_size=hidden_size, output_dim=ld + 2,
            add_space_attn=use_spaceatt)
        self.query_ref_token = nn.Parameter(torch.zeros(1, 2, tdim))
        self.ffeat_norm = GroupNorm(1, ld, eps=1e-5)
        self.ffeat_updater = Dense(ld, ld)
        self.vis_predictor = Dense(ld, 1)
        self.conf_predictor = Dense(ld, 1) if predict_conf else None

    def forward(self, query_points, fmaps, iters: Optional[int] = None,
                down_ratio: int = 1, apply_sigmoid: bool = True,
                query_valid=None):
        iters = self.iters if iters is None else iters
        B, S, HH, WW, _ = fmaps.shape
        N = query_points.shape[1]
        ld = self.latent_dim
        tdim = 3 * ld + 4

        fmaps = self.fmap_norm(fmaps)
        if down_ratio > 1:
            query_points = query_points / float(down_ratio)
        query_points = query_points / float(self.stride)
        coords = query_points[:, None].expand(B, S, N, 2)
        q_feat = torch.stack([bilinear_sample(fmaps[b, 0], coords[b, 0],
                                              "border") for b in range(B)])
        track_feats = q_feat[:, None].expand(B, S, N, ld)
        coords_backup = coords
        pos_table = constant(_pos_table(tdim, HH, WW), fmaps.device)
        qr = torch.cat([self.query_ref_token[:, 0:1],
                        self.query_ref_token[:, 1:2].expand(1, S - 1, tdim)],
                       dim=1)

        coord_preds = []
        for _ in range(iters):
            coords = coords.detach()
            fcorrs = corr_pyramid_sample(fmaps, track_feats, coords,
                                         self.corr_levels, self.corr_radius)
            fcorrs_ = self.corr_mlp(fcorrs.transpose(1, 2).reshape(B * N, S, -1))
            flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
            flows_emb = torch.cat([get_2d_embedding(flows, ld // 2),
                                   flows / self.max_scale,
                                   flows / self.max_scale], dim=-1)
            track_feats_ = track_feats.transpose(1, 2).reshape(B * N, S, ld)
            tinput = torch.cat([flows_emb, fcorrs_, track_feats_], dim=-1)
            sampled_pos = torch.stack([bilinear_sample(pos_table, coords[b, 0],
                                                       "border")
                                       for b in range(B)])
            x = tinput + sampled_pos.reshape(B * N, 1, tdim) + qr
            delta = self.updateformer(x.reshape(B, N, S, tdim),
                                      valid=query_valid).reshape(B * N, S, ld + 2)
            tf_flat = track_feats_.reshape(B * N * S, ld)
            upd = F.gelu(self.ffeat_updater(self.ffeat_norm(
                delta[:, :, 2:].reshape(B * N * S, ld))))
            track_feats = (upd + tf_flat).reshape(B, N, S, ld).transpose(1, 2)
            coords = coords + delta[:, :, :2].reshape(B, N, S, 2).transpose(1, 2)
            coords = torch.cat([coords_backup[:, :1], coords[:, 1:]], dim=1)
            coord_preds.append(coords * self.stride * down_ratio)

        vis = self.vis_predictor(track_feats).reshape(B, S, N)
        conf = None
        if self.conf_predictor is not None:
            conf = self.conf_predictor(track_feats).reshape(B, S, N)
        if apply_sigmoid:
            vis = torch.sigmoid(vis)
            conf = None if conf is None else torch.sigmoid(conf)
        return coord_preds, vis, conf


_POS_TABLES: dict = {}


def _pos_table(tdim: int, hh: int, ww: int) -> np.ndarray:
    """The sincos table of one feature-map size, made once (and, through
    ``utils.device.constant``, copied to the card once)."""
    key = (tdim, hh, ww)
    if key not in _POS_TABLES:
        _POS_TABLES[key] = sincos_pos_embed_2d(tdim, hh, ww)
    return _POS_TABLES[key]


class TrackResult(NamedTuple):
    tracks: torch.Tensor      # (B, S, N, 2) pixel positions (final iter)
    visibility: torch.Tensor  # (B, S, N) in [0, 1]
    confidence: Optional[torch.Tensor] = None


class TrackHead(nn.Module):
    """The reference TrackHead: a DPT feature extractor (``feature_only``,
    ``down_ratio`` 2 → ``(B, S, H/2, W/2, features)`` maps) and the
    ``BaseTrackerPredictor``. ``taps``: 4 aggregator token tensors ``(B, S,
    P, dim_in)`` (VGGT's ``return_taps``), computed at ``img_hw`` pixels.
    :meth:`features` and :meth:`track` are the two halves of ``forward``:
    the feature maps do not depend on the queries, so a caller that tracks
    several query chunks on the same taps makes them once."""

    def __init__(self, dim_in: int = 2048, patch_size: int = 14,
                 features: int = 128, iters: int = 4,
                 predict_conf: bool = True, stride: int = 2,
                 corr_levels: int = 7, corr_radius: int = 4,
                 hidden_size: int = 384, img_hw=(518, 518),
                 patch_start_idx: int = 5):
        super().__init__()
        from skix_torch.models.vggt import DPTHead

        self.img_hw = tuple(img_hw)
        self.patch_start_idx = patch_start_idx
        self.feature_extractor = DPTHead(
            dim_in=dim_in, patch_size=patch_size, features=features,
            feature_only=True, down_ratio=2)
        self.tracker = BaseTrackerPredictor(
            latent_dim=features, predict_conf=predict_conf, stride=stride,
            corr_levels=corr_levels, corr_radius=corr_radius,
            hidden_size=hidden_size, iters=iters)

    def init_weights(self, generator=None) -> "TrackHead":
        """flax's initializers: LeCun-normal kernels, xavier-uniform packed
        in-projections, N(0, 1) virtual tracks and query/ref token, the
        flow head N(0, 0.001²) truncated at 2σ."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, TorchMHA):
                    fan_in, fan_out = m.in_proj_weight.shape[1], m.in_proj_weight.shape[0]
                    a = math.sqrt(6.0 / (fan_in + fan_out))
                    m.in_proj_weight.uniform_(-a, a, generator=generator)
                    m.in_proj_bias.zero_()
            uf = self.tracker.updateformer
            if uf.add_space_attn:
                uf.virual_tracks.normal_(0.0, 1.0, generator=generator)
            self.tracker.query_ref_token.normal_(0.0, 1.0, generator=generator)
            std = 0.001 / 0.87962566103423978
            nn.init.trunc_normal_(uf.flow_head.weight, 0.0, std, -2 * std,
                                  2 * std, generator=generator)
        return self

    def features(self, taps) -> torch.Tensor:
        return self.feature_extractor(list(taps), self.img_hw,
                                      self.patch_start_idx)

    def track(self, fmaps, query_points, query_valid=None,
              iters: Optional[int] = None):
        return self.tracker(query_points, fmaps, iters=iters,
                            query_valid=query_valid)

    def forward(self, taps, query_points, query_valid=None,
                iters: Optional[int] = None):
        return self.track(self.features(taps), query_points, query_valid,
                          iters)


def track_points(model: TrackHead, taps, queries) -> TrackResult:
    """The final iteration's tracks, visibility and confidence."""
    coords, vis, conf = model(tuple(taps), queries)
    return TrackResult(tracks=coords[-1], visibility=vis, confidence=conf)
