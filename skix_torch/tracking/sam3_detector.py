"""SAM3-family open-vocabulary promptable detector.

Port of ``skix/tracking/sam3_detector.py``: ViT-Det backbone + SimpleFPN
neck (:mod:`skix_torch.tracking.vitdet`), the vision–language fusion
encoder, the query decoder with iterative box refinement, boxRPB attention
bias, presence token and DAC one-to-many training queries, dot-product
scoring against the pooled prompt (per decoder layer with
``with_aux_scores``), and the maskformer pixel decoder + mask predictor.
Without a text prompt the detector runs unconditioned on its learned
``null_prompt`` token, as skix's ``train_detector`` trains it. Point and
box prompts go through the geometry prompt encoder (direct projection +
pooled image feature + sine position + label embedding per slot) and are
appended to the text prompt, pads and all.

Attention: an unbiased, unmasked self-attention of ``L ≥ flash_min_seq``
tokens (the fusion encoder's image self-attention, 5184 tokens of head
dim 32 at 1008 px) goes through the flash kernel K1 (and K3/K4 in the
backward); every other attention is a plain einsum/softmax, as in skix.

``rope_style="sam3"`` with the reference's ``pretrain_img_size`` (336) is
the trunk configuration that converted SAM3 weights need (the interleaved
rope through K1/K2, :mod:`skix_torch.tracking.vitdet`). The converters of
reference state dicts come beside each module:
:func:`skix_torch.tracking.vitdet.convert_vitdet_state_dict` for the
trunk, :func:`convert_fusion_encoder` here for the fusion encoder.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Conv, Dense, GroupNorm, LayerNorm,
                                      init_like_flax)
from skix_torch.ops.attention import flash_attention
from skix_torch.tracking.vitdet import SimpleFPNNeck, ViTDetBackbone
from skix_torch.utils.image import resize

def _inverse_sigmoid(x, eps: float = 1e-5):
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


class _MHA(nn.Module):
    """Batch-first multi-head attention with an optional key padding mask
    (True = PAD) and additive bias."""

    def __init__(self, dim: int, num_heads: int, flash_min_seq: int = 2048):
        super().__init__()
        self.num_heads = num_heads
        self.flash_min_seq = flash_min_seq
        self.q, self.k, self.v, self.out = (Dense(dim, dim) for _ in range(4))

    def forward(self, q, k, v, key_padding_mask=None, attn_bias=None):
        B, Lq, C = q.shape
        H = self.num_heads
        hd = C // H
        qh = self.q(q).reshape(B, Lq, H, hd)
        kh = self.k(k).reshape(B, k.shape[1], H, hd)
        vh = self.v(v).reshape(B, v.shape[1], H, hd)
        if (attn_bias is None and key_padding_mask is None
                and k.shape[1] == Lq and Lq >= self.flash_min_seq):
            blk = 576 if Lq % 576 == 0 else 1024
            out = flash_attention(
                qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                block_q=blk, block_k_major=blk, block_k=blk
            ).transpose(1, 2).reshape(B, Lq, C)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
            if attn_bias is not None:
                s = s + attn_bias
            if key_padding_mask is not None:
                s = torch.where(key_padding_mask[:, None, None, :],
                                torch.full_like(s, -1e9), s)
            p = torch.softmax(s, dim=-1).to(vh.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, Lq, C)
        return self.out(out)


class _FFN(nn.Module):
    def __init__(self, dim: int, dim_feedforward: int = 2048):
        super().__init__()
        self.linear1 = Dense(dim, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, dim)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


def pool_prompt(prompt, prompt_pad_mask=None):
    """Masked mean over the prompt sequence."""
    if prompt_pad_mask is None:
        return prompt.mean(dim=1)
    valid = (~prompt_pad_mask).to(prompt.dtype)[..., None]
    n = torch.clamp(valid.sum(dim=1), min=1.0)
    return (prompt * valid).sum(dim=1) / n


# --------------------------------------------------------------------------
# geometry prompt encoder
# --------------------------------------------------------------------------
def _bilinear_sample(feat, pts01):
    """``feat (B, H, W, C)``, ``pts01 (B, N, 2)`` (x, y) in [0, 1] →
    ``(B, N, C)``: skix's own gather (floor, the four taps' indices clipped
    to the grid, then the blend), not ``F.grid_sample``."""
    B, H, W, _ = feat.shape
    x = pts01[..., 0] * W - 0.5
    y = pts01[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    b = torch.arange(B, device=feat.device)[:, None]

    def at(yy, xx):
        return feat[b, yy.long().clamp(0, H - 1), xx.long().clamp(0, W - 1)]

    return ((1 - wy) * ((1 - wx) * at(y0, x0) + wx * at(y0, x0 + 1))
            + wy * ((1 - wx) * at(y0 + 1, x0) + wx * at(y0 + 1, x0 + 1)))


def bilinear_sample(feat, pts01):
    """``feat (H, W, C)``, ``pts01 (N, 2)`` (x, y) in [0, 1] → (N, C)."""
    return _bilinear_sample(feat[None], pts01[None])[0]


def _box_grid_sample(feat, boxes_cxcywh, grid: int = 7):
    """``feat (B, H, W, C)``, ``boxes (B, N, 4)`` → ``(B, N, C)``: the mean
    of a ``grid × grid`` bilinear sample inside each normalized box."""
    B, N = boxes_cxcywh.shape[:2]
    cx, cy, w, h = boxes_cxcywh.unbind(-1)
    lin = (torch.arange(grid, device=feat.device) + 0.5) / grid
    gx = cx[..., None] - w[..., None] / 2 + lin * w[..., None]   # (B, N, g)
    gy = cy[..., None] - h[..., None] / 2 + lin * h[..., None]
    pts = torch.stack([gx.repeat_interleave(grid, -1),
                       gy.repeat(1, 1, grid)], -1)              # (B, N, g², 2)
    samples = _bilinear_sample(feat, pts.reshape(B, N * grid * grid, 2))
    return samples.reshape(B, N, grid * grid, -1).mean(dim=2)


def box_grid_sample(feat, boxes_cxcywh, grid: int = 7):
    """``feat (H, W, C)``, ``boxes (N, 4)`` normalized cxcywh → (N, C)."""
    return _box_grid_sample(feat[None], boxes_cxcywh[None], grid)[0]


def _sincos_vec(v, dim: int, temperature: float = 10000.0):
    """1D sine-cosine features of ``v (...,)`` → (..., dim)."""
    dim_t = temperature ** (2 * torch.arange(dim // 2, device=v.device) / dim)
    f = v[..., None] / dim_t
    return torch.cat([torch.sin(f), torch.cos(f)], dim=-1)


class GeometryPromptEncoder(nn.Module):
    """Point and box prompts → ``(B, Np + Nb, d_model)`` tokens and their
    pad mask (True = pad). Each slot embeds as direct projection + pooled
    image feature + sine position + label embedding (points neg/pos, boxes
    neg/pos); invalid slots are zeroed and padded."""

    def __init__(self, d_model: int = 256, max_points: int = 8,
                 max_boxes: int = 4, roi_grid: int = 7):
        super().__init__()
        self.d_model, self.roi_grid = d_model, roi_grid
        self.max_points, self.max_boxes = max_points, max_boxes
        self.label_embed = nn.Parameter(torch.zeros(4, d_model))
        self.points_direct = Dense(2, d_model)
        self.points_pool = Dense(d_model, d_model)
        self.points_pos = Dense(2 * (d_model // 2), d_model)
        self.boxes_direct = Dense(4, d_model)
        self.boxes_pool = Dense(d_model, d_model)
        self.boxes_pos = Dense(4 * (d_model // 4), d_model)

    def forward(self, img_feat, points, point_labels, point_valid, boxes,
                box_labels, box_valid):
        """``img_feat (B, h, w, d)``; ``points (B, Np, 2)`` in [0, 1];
        ``boxes (B, Nb, 4)`` normalized cxcywh; labels int (0 = negative,
        1 = positive); valid bool masks."""
        d = self.d_model
        p_tok = (self.points_direct(points)
                 + self.points_pool(_bilinear_sample(img_feat, points))
                 + self.points_pos(torch.cat(
                     [_sincos_vec(points[..., 0], d // 2),
                      _sincos_vec(points[..., 1], d // 2)], -1))
                 + self.label_embed[point_labels.long().clamp(0, 1)])
        b_tok = (self.boxes_direct(boxes)
                 + self.boxes_pool(_box_grid_sample(img_feat, boxes,
                                                    self.roi_grid))
                 + self.boxes_pos(torch.cat(
                     [_sincos_vec(boxes[..., i], d // 4) for i in range(4)],
                     -1))
                 + self.label_embed[2 + box_labels.long().clamp(0, 1)])
        tokens = torch.cat([p_tok, b_tok], 1)
        valid = torch.cat([point_valid, box_valid], 1).to(torch.bool)
        return torch.where(valid[..., None], tokens, 0.0), ~valid

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions: kernels
        LeCun-normal, biases 0, ``label_embed`` normal(0.02)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.label_embed.normal_(0.0, 0.02, generator=generator)
        return self


def geometry_slots(max_points: int, max_boxes: int, lead=()) -> dict:
    """Point and box slots, every one invalid, with leading axes ``lead``:
    the detector's six geometry keywords as numpy arrays (points normalized
    xy, boxes normalized cxcywh, int32 labels, bool valid masks)."""
    return {"points": np.zeros((*lead, max_points, 2), np.float32),
            "point_labels": np.zeros((*lead, max_points), np.int32),
            "point_valid": np.zeros((*lead, max_points), bool),
            "boxes": np.zeros((*lead, max_boxes, 4), np.float32),
            "box_labels": np.zeros((*lead, max_boxes), np.int32),
            "box_valid": np.zeros((*lead, max_boxes), bool)}


# --------------------------------------------------------------------------
# vision-language fusion encoder
# --------------------------------------------------------------------------
class FusionEncoderLayer(nn.Module):
    """Pre-norm: image self-attn (positions at attention) → cross-attn to
    the prompt → ReLU FFN."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dim_feedforward: int = 2048, self_flash_min_seq: int = 2048):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5)
        self.self_attn = _MHA(dim, num_heads, self_flash_min_seq)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.cross_attn_image = _MHA(dim, num_heads)
        self.norm3 = LayerNorm(dim, 1e-5)
        self.ffn = _FFN(dim, dim_feedforward)

    def forward(self, src, pos, prompt, prompt_pad_mask=None):
        h = self.norm1(src)
        qk = h + pos
        src = src + self.self_attn(qk, qk, h)
        h = self.norm2(src)
        src = src + self.cross_attn_image(h, prompt, prompt,
                                          key_padding_mask=prompt_pad_mask)
        return src + self.ffn(self.norm3(src))


class FusionEncoder(nn.Module):
    def __init__(self, dim: int, num_layers: int = 6, num_heads: int = 8,
                 dim_feedforward: int = 2048, self_flash_min_seq: int = 2048):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", FusionEncoderLayer(
                dim, num_heads, dim_feedforward, self_flash_min_seq))

    def forward(self, src, pos, prompt, prompt_pad_mask=None):
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, pos, prompt,
                                              prompt_pad_mask)
        return src.to(torch.float32)


# --------------------------------------------------------------------------
# query decoder with box refinement + presence token
# --------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.norm_sa = LayerNorm(dim, 1e-5)
        self.self_attn = _MHA(dim, num_heads)
        self.norm_ta = LayerNorm(dim, 1e-5)
        self.text_cross_attn = _MHA(dim, num_heads)
        self.norm_ca = LayerNorm(dim, 1e-5)
        self.image_cross_attn = _MHA(dim, num_heads)
        self.norm_ffn = LayerNorm(dim, 1e-5)
        self.ffn = _FFN(dim, dim_feedforward)

    def forward(self, q, query_pos, memory, mem_pos, prompt,
                prompt_pad_mask=None, attn_bias=None, dac_split=None):
        """``dac_split`` (int | None): the query axis is laid out
        ``[o2o(dac_split), o2m(dac_split), presence(rest)]`` and
        self-attention runs over o2o + presence only; the o2m queries skip
        it. Cross-attention and the FFN apply to every query either way."""
        if dac_split is None:
            h = self.norm_sa(q)
            hq = h + query_pos
            q = q + self.self_attn(hq, hq, h)
        else:
            Qo = dac_split
            sa = torch.cat([q[:, :Qo], q[:, 2 * Qo:]], 1)
            sa_pos = torch.cat([query_pos[:, :Qo], query_pos[:, 2 * Qo:]], 1)
            h = self.norm_sa(sa)
            hq = h + sa_pos
            upd = self.self_attn(hq, hq, h)
            q = torch.cat([q[:, :Qo] + upd[:, :Qo], q[:, Qo:2 * Qo],
                           q[:, 2 * Qo:] + upd[:, Qo:]], 1)
        h = self.norm_ta(q)
        q = q + self.text_cross_attn(h + query_pos, prompt, prompt,
                                     key_padding_mask=prompt_pad_mask)
        h = self.norm_ca(q)
        q = q + self.image_cross_attn(h + query_pos, memory + mem_pos, memory,
                                      attn_bias=attn_bias)
        return q + self.ffn(self.norm_ffn(q))


class BoxRPB(nn.Module):
    """Box relative position bias, 'log' mode: signed-log deltas from each
    feature row/column to the box edges through per-axis 2-layer MLPs,
    combined separably over (h, w)."""

    def __init__(self, num_heads: int = 8, d_model: int = 256):
        super().__init__()
        self.num_heads = num_heads
        self.embed_y_fc1 = Dense(2, d_model)
        self.embed_y_fc2 = Dense(d_model, num_heads)
        self.embed_x_fc1 = Dense(2, d_model)
        self.embed_x_fc2 = Dense(d_model, num_heads)

    def forward(self, boxes_cxcywh, h: int, w: int):
        """``boxes (B, Q, 4)`` normalized → bias (B, heads, Q, h·w)."""
        cx, cy, bw, bh = boxes_cxcywh.unbind(-1)
        x1, x2 = cx - bw / 2, cx + bw / 2
        y1, y2 = cy - bh / 2, cy + bh / 2
        dev = boxes_cxcywh.device
        coords_h = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        coords_w = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        dy = coords_h[None, None, :, None] - torch.stack([y1, y2], -1)[:, :, None, :]
        dx = coords_w[None, None, :, None] - torch.stack([x1, x2], -1)[:, :, None, :]

        def logmap(d):
            d = d * 8.0
            return torch.sign(d) * torch.log2(d.abs() + 1.0) / math.log2(8.0)

        by = self.embed_y_fc2(F.relu(self.embed_y_fc1(logmap(dy))))
        bx = self.embed_x_fc2(F.relu(self.embed_x_fc1(logmap(dx))))
        bias = by[:, :, :, None, :] + bx[:, :, None, :, :]  # (B,Q,h,w,heads)
        B, Q = boxes_cxcywh.shape[:2]
        return bias.reshape(B, Q, h * w, self.num_heads).permute(0, 3, 1, 2)


class _BoxHead(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1, self.fc2 = Dense(dim, dim), Dense(dim, dim)
        self.fc3 = Dense(dim, 4)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class DecoderOut(NamedTuple):
    queries: torch.Tensor       # (B, Q, C) final-layer o2o features
    boxes: torch.Tensor         # (B, Q, 4) refined o2o boxes
    all_boxes: tuple            # per-layer o2o boxes
    presence: torch.Tensor      # (B, C) presence feature
    all_queries: tuple = ()     # per-layer o2o features
    o2m_queries: torch.Tensor = None    # (B, Q, C) with apply_dac
    o2m_boxes: torch.Tensor = None      # (B, Q, 4) with apply_dac
    o2m_all_boxes: tuple = ()           # per-layer o2m boxes
    o2m_all_queries: tuple = ()         # per-layer o2m features


class QueryDecoder(nn.Module):
    """``num_queries`` learned queries + the presence token."""

    def __init__(self, dim: int, num_queries: int = 200, num_layers: int = 6,
                 num_heads: int = 8, dim_feedforward: int = 2048,
                 box_rpb: str = "none"):
        super().__init__()
        self.num_queries, self.num_layers = num_queries, num_layers
        self.query_pos = nn.Parameter(torch.zeros(1, num_queries + 1, dim))
        self.init_boxes = nn.Parameter(torch.zeros(1, num_queries, 4))
        self.box_head = _BoxHead(dim)
        if box_rpb not in ("none", "log"):
            raise ValueError(f"box_rpb {box_rpb!r}: 'none' or 'log'")
        self.box_rpb = BoxRPB(num_heads, dim) if box_rpb == "log" else None
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(dim, num_heads,
                                                       dim_feedforward))
            self.add_module(f"norm_out_{i}", LayerNorm(dim, 1e-5))

    def forward(self, memory, mem_pos, prompt, prompt_pad_mask=None,
                feat_hw=None, apply_dac: bool = False):
        """``apply_dac`` (training): the queries are tiled ×2, laid out
        ``[o2o(Q), o2m(Q), presence]``; the o2m half reuses the o2o query
        positions and initial boxes and skips self-attention, so the o2o
        outputs do not depend on the flag."""
        B, C = memory.shape[0], memory.shape[-1]
        Q = self.num_queries
        query_pos = self.query_pos
        boxes = torch.sigmoid(self.init_boxes)
        if apply_dac:
            query_pos = torch.cat([query_pos[:, :Q], query_pos[:, :Q],
                                   query_pos[:, Q:]], 1)
            boxes = torch.cat([boxes, boxes], 1)
        nq = boxes.shape[1]
        query_pos = query_pos.expand(B, -1, -1)
        q = memory.new_zeros(B, nq + 1, C)
        boxes = boxes.expand(B, nq, 4)
        dac_split = Q if apply_dac else None
        all_boxes, all_q = [], []
        for i in range(self.num_layers):
            attn_bias = None
            if self.box_rpb is not None:
                if feat_hw is None:
                    raise ValueError("box_rpb needs the memory (h, w)")
                # bias from the current reference boxes; the presence
                # token attends unbiased (zero row)
                attn_bias = self.box_rpb(boxes, *feat_hw)
                attn_bias = torch.cat(
                    [attn_bias, torch.zeros_like(attn_bias[:, :, :1])], 2)
            q = getattr(self, f"layer_{i}")(q, query_pos, memory, mem_pos,
                                            prompt, prompt_pad_mask,
                                            attn_bias=attn_bias,
                                            dac_split=dac_split)
            hq = getattr(self, f"norm_out_{i}")(q)
            delta = self.box_head(hq[:, :nq])
            boxes = torch.sigmoid(_inverse_sigmoid(boxes) + delta)
            all_boxes.append(boxes)
            all_q.append(hq[:, :nq])
        presence = hq[:, nq]
        if apply_dac:
            return DecoderOut(
                queries=hq[:, :Q], boxes=boxes[:, :Q],
                all_boxes=tuple(b[:, :Q] for b in all_boxes),
                presence=presence,
                all_queries=tuple(x[:, :Q] for x in all_q),
                o2m_queries=hq[:, Q:2 * Q], o2m_boxes=boxes[:, Q:],
                o2m_all_boxes=tuple(b[:, Q:] for b in all_boxes),
                o2m_all_queries=tuple(x[:, Q:] for x in all_q))
        return DecoderOut(queries=hq[:, :Q], boxes=boxes,
                          all_boxes=tuple(all_boxes), presence=presence,
                          all_queries=tuple(all_q))


# --------------------------------------------------------------------------
# scoring + segmentation heads
# --------------------------------------------------------------------------
class DotProductScoring(nn.Module):
    """Query ↔ pooled-prompt dot product: residual 2-layer prompt MLP with
    output LN per token, masked mean pool, projections to ``d_proj``,
    scaled inner product, logits clamped to ±``clamp_max_val``."""

    def __init__(self, dim: int, d_proj: int = 256,
                 clamp_max_val: float = 12.0):
        super().__init__()
        self.d_proj, self.clamp_max_val = d_proj, clamp_max_val
        self.prompt_fc1 = Dense(dim, 2048)
        self.prompt_fc2 = Dense(2048, dim)
        self.prompt_norm = LayerNorm(dim, 1e-5)
        self.proj_q = Dense(dim, d_proj)
        self.proj_p = Dense(dim, d_proj)

    def forward(self, queries, prompt, prompt_pad_mask=None):
        h = self.prompt_fc2(F.relu(self.prompt_fc1(prompt)))
        prompt = self.prompt_norm(prompt + h)
        pooled = pool_prompt(prompt, prompt_pad_mask)
        pq, pp = self.proj_q(queries), self.proj_p(pooled)
        scores = torch.einsum("bqc,bc->bq", pq, pp) / math.sqrt(self.d_proj)
        return torch.clamp(scores, -self.clamp_max_val, self.clamp_max_val)


class PixelDecoder(nn.Module):
    """Top-down FPN fusion: the coarsest level upsampled (nearest) and added
    into the finer levels, conv + GroupNorm + ReLU per stage."""

    def __init__(self, dim: int, hidden_dim: int = 256, num_levels: int = 3):
        super().__init__()
        for li in range(num_levels - 1):
            self.add_module(f"conv_{li}", Conv(dim if li == 0 else hidden_dim,
                                               hidden_dim, 3))
            self.add_module(f"norm_{li}", GroupNorm(8, hidden_dim))

    def forward(self, feats):
        """``feats``: fine → coarse (B, h, w, d) → (B, H, W, hidden) at the
        finest level's resolution."""
        prev = feats[-1]
        for li, f in enumerate(feats[:-1][::-1]):
            prev = resize(prev, f.shape, "nearest") + f
            prev = getattr(self, f"conv_{li}")(prev)
            prev = F.relu(getattr(self, f"norm_{li}")(prev))
        return prev.to(torch.float32)


class MaskPredictor(nn.Module):
    """Per-query masks: 3-layer MLP mask embedding × pixel embedding."""

    def __init__(self, dim: int, hidden_dim: int = 256,
                 pixel_dim: Optional[int] = None):
        super().__init__()
        self.fc0 = Dense(dim, hidden_dim)
        self.fc1 = Dense(hidden_dim, hidden_dim)
        self.fc2 = Dense(hidden_dim, pixel_dim or hidden_dim)

    def forward(self, queries, pixel_embed):
        h = F.relu(self.fc1(F.relu(self.fc0(queries))))
        return torch.einsum("bqc,bhwc->bqhw", self.fc2(h), pixel_embed)


# --------------------------------------------------------------------------
# the full detector
# --------------------------------------------------------------------------
class Sam3Detections(NamedTuple):
    boxes_cxcywh: torch.Tensor  # (B, Q, 4) normalized
    scores: torch.Tensor        # (B, Q) prompt-alignment logits
    mask_logits: torch.Tensor   # (B, Q, H4, W4)
    embeddings: torch.Tensor    # (B, Q, C) decoder features
    presence: torch.Tensor      # (B,) presence logit
    aux_boxes: tuple            # per-layer boxes
    # DAC one-to-many outputs (training, apply_dac=True)
    o2m_boxes: torch.Tensor = None       # (B, Q, 4)
    o2m_scores: torch.Tensor = None      # (B, Q)
    o2m_mask_logits: torch.Tensor = None  # (B, Q, H4, W4)
    o2m_aux_boxes: tuple = ()            # per-layer o2m boxes
    # per-layer logits of the decoder's queries through the same scoring
    # head (with_aux_scores=True)
    aux_scores: tuple = ()               # per-layer (B, Q)
    o2m_aux_scores: tuple = ()           # per-layer (B, Q)


class Sam3Detector(nn.Module):
    """Image + (text prompt memory | point and box prompts) → promptable
    detections.

    ``full_size()`` is the reference configuration (1008 px, 1024×32
    ViT-Det, d_model 256, 200 queries, 6+6 layers); ``tiny()`` the test
    configuration of skix.

    ``null_prompt``: the model has the learned ``null_prompt`` token that
    an unconditioned call (no text memory, no geometry) attends to.
    ``geometry``: the model has the geometry prompt encoder
    (``geometry_encoder``) of ``max_points`` point and ``max_boxes`` box
    slots. skix creates each of those parameters only when its ``init`` ran
    with that kind of prompt (``train_detector``'s init has no prompt, the
    committed tracker fixtures' a text prompt alone), so a variables tree
    has them or not; the flags mirror that. A caller that prompts a model
    built without the branch brings its own encoder (:meth:`
    make_geometry_encoder`, ``forward(geometry_encoder=...)``), as skix's
    ``Sam3Processor`` and ``VideoPredictor`` merge a grafted branch into
    their own variables; the model is not changed.
    ``remat`` recomputes each trunk block in the backward
    (``torch.utils.checkpoint``), skix's ``nn.remat``; off by default."""

    def __init__(self, img_size: int = 1008, patch_size: int = 14,
                 backbone_dim: int = 1024, backbone_depth: int = 32,
                 backbone_heads: int = 16, mlp_ratio: float = 4.625,
                 window_size: int = 24,
                 global_att_blocks: Sequence[int] = (7, 15, 23, 31),
                 d_model: int = 256, num_queries: int = 200,
                 encoder_layers: int = 6, decoder_layers: int = 6,
                 max_points: int = 8, max_boxes: int = 4,
                 box_rpb: str = "log", window_flash: bool = True,
                 tail_flash: bool = True, rope_style: str = "skix",
                 pretrain_img_size: Optional[int] = None,
                 remat: bool = False, null_prompt: bool = False,
                 geometry: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.d_model = img_size, d_model
        self.num_queries = num_queries
        self.max_points, self.max_boxes = max_points, max_boxes
        self.backbone = ViTDetBackbone(
            img_size=img_size, patch_size=patch_size, embed_dim=backbone_dim,
            depth=backbone_depth, num_heads=backbone_heads,
            mlp_ratio=mlp_ratio, window_size=window_size,
            global_att_blocks=global_att_blocks, window_flash=window_flash,
            rope_style=rope_style, pretrain_img_size=pretrain_img_size,
            remat=remat, dtype=dtype)
        self.null_prompt = (nn.Parameter(torch.zeros(1, 1, d_model))
                            if null_prompt else None)
        self.geometry_encoder = (GeometryPromptEncoder(d_model, max_points,
                                                       max_boxes)
                                 if geometry else None)
        self.neck = SimpleFPNNeck(backbone_dim, d_model)
        self.encoder = FusionEncoder(
            d_model, encoder_layers,
            self_flash_min_seq=2048 if tail_flash else 1 << 30)
        self.decoder = QueryDecoder(d_model, num_queries, decoder_layers,
                                    box_rpb=box_rpb)
        self.scoring = DotProductScoring(d_model, d_model)
        self.presence_head = Dense(d_model, 1)
        self.pixel_decoder = PixelDecoder(d_model, d_model)
        self.mask_predictor = MaskPredictor(d_model, d_model)

    @classmethod
    def full_size(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(img_size=112, patch_size=14, backbone_dim=64,
                        backbone_depth=2, backbone_heads=2, mlp_ratio=4.0,
                        window_size=4, global_att_blocks=(1,), d_model=64,
                        num_queries=12, encoder_layers=2, decoder_layers=2)
        defaults.update(kw)
        return cls(**defaults)

    def init_weights(self, generator=None):
        """Random weights in the distributions of flax's init: kernels
        LeCun-normal, biases 0, norms 1/0, ``pos_embed``/``query_pos``
        normal(0.02), ``init_boxes`` normal(0.5)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for p, std in ((self.backbone.pos_embed, 0.02),
                           (self.decoder.query_pos, 0.02),
                           (self.decoder.init_boxes, 0.5),
                           (self.null_prompt, 0.02)):
                if p is not None:
                    p.normal_(0.0, std, generator=generator)
            if self.geometry_encoder is not None:
                self.geometry_encoder.label_embed.normal_(
                    0.0, 0.02, generator=generator)
        return self

    def make_geometry_encoder(self, generator=None):
        """A new geometry prompt encoder of this model's width and slots,
        its weights drawn from ``generator`` (flax's init distributions), on
        the model's device. The model keeps its own branch, or none."""
        enc = GeometryPromptEncoder(self.d_model, self.max_points,
                                    self.max_boxes).init_weights(generator)
        return enc.to(self.presence_head.weight.device)

    def forward(self, images, text_memory=None, text_pad_mask=None,
                points=None, point_labels=None, point_valid=None,
                boxes=None, box_labels=None, box_valid=None,
                geometry_encoder=None, apply_dac: bool = False,
                with_aux_scores: bool = False):
        """``images (B, H, W, 3)`` in [0, 1]; ``text_memory (B, L, d_model)``
        (CLIP resizer output, or the hash smoke embedding), or None. Point
        and box prompts (needs ``geometry``): ``points (B, max_points, 2)``
        normalized xy, ``boxes (B, max_boxes, 4)`` normalized cxcywh, int
        labels (0 = negative, 1 = positive) and bool valid masks per slot;
        a missing one of the six is zeros (no valid slot).
        ``geometry_encoder`` encodes them in place of the model's own
        branch. The prompt is text ‖ geometry; with neither, the
        ``null_prompt`` token.
        ``apply_dac=True`` (training) adds the DAC one-to-many outputs;
        ``with_aux_scores=True`` (training) scores every decoder layer's
        queries through the shared scoring head."""
        B = images.shape[0]
        dev = images.device
        use_geometry = points is not None or boxes is not None
        if geometry_encoder is None:
            geometry_encoder = self.geometry_encoder
        if use_geometry and geometry_encoder is None:
            raise ValueError("point or box prompts, and this detector has no "
                             "geometry encoder (build it with geometry=True, "
                             "or pass one from make_geometry_encoder)")
        trunk = self.backbone((images - 0.5) / 0.5)
        feats, poss = self.neck(trunk)
        f = feats[2]                 # the 1.0-scale level (stride = patch)
        h, w = f.shape[1], f.shape[2]
        src = f.reshape(B, h * w, self.d_model)
        pos = poss[2].reshape(1, h * w, self.d_model)
        prompts, pads = [], []
        if text_memory is not None:
            prompts.append(text_memory)
            pads.append(torch.zeros(text_memory.shape[:2], dtype=torch.bool,
                                    device=dev)
                        if text_pad_mask is None else text_pad_mask)
        if use_geometry:
            given = (points, point_labels, point_valid, boxes, box_labels,
                     box_valid)
            empty = geometry_slots(self.max_points, self.max_boxes, (B,))
            g_tok, g_pad = geometry_encoder(f, *(
                torch.as_tensor(e, device=dev) if x is None else x
                for x, e in zip(given, empty.values())))
            prompts.append(g_tok)
            pads.append(g_pad)
        if not prompts:
            if self.null_prompt is None:
                raise ValueError("no text prompt, and this detector has no "
                                 "null_prompt (build it with "
                                 "null_prompt=True)")
            prompts.append(self.null_prompt.expand(B, 1, self.d_model))
            pads.append(torch.zeros((B, 1), dtype=torch.bool, device=dev))
        prompt = prompts[0] if len(prompts) == 1 else torch.cat(prompts, 1)
        prompt_pad = pads[0] if len(pads) == 1 else torch.cat(pads, 1)
        memory = self.encoder(src, pos, prompt, prompt_pad)
        dec = self.decoder(memory, pos, prompt, prompt_pad, feat_hw=(h, w),
                           apply_dac=apply_dac)
        # score/mask the o2o and (with DAC) o2m halves through the same
        # heads in one pass; the aux layers' queries ride the same call
        parts = [dec.queries]
        if apply_dac:
            parts.append(dec.o2m_queries)
        n_aux = 0
        if with_aux_scores:
            aux_parts = list(dec.all_queries[:-1])
            if apply_dac:
                aux_parts += list(dec.o2m_all_queries[:-1])
            n_aux = len(dec.all_queries) - 1
            parts += aux_parts
        head_q = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        scores_all = self.scoring(head_q, prompt, prompt_pad)
        pres_logit = self.presence_head(dec.presence)[..., 0]
        fused = memory.reshape(B, h, w, self.d_model)
        pixel_embed = self.pixel_decoder([feats[0], feats[1], fused])
        Q = self.num_queries
        n_main = Q * (2 if apply_dac else 1)
        masks_all = self.mask_predictor(head_q[:, :n_main], pixel_embed)
        extra = {}
        if apply_dac:
            extra.update(o2m_boxes=dec.o2m_boxes,
                         o2m_scores=scores_all[:, Q:2 * Q],
                         o2m_mask_logits=masks_all[:, Q:],
                         o2m_aux_boxes=dec.o2m_all_boxes)
        if with_aux_scores and n_aux:
            aux_flat = scores_all[:, n_main:]
            per = [aux_flat[:, i * Q:(i + 1) * Q]
                   for i in range(aux_flat.shape[1] // Q)]
            extra["aux_scores"] = tuple(per[:n_aux])
            if apply_dac:
                extra["o2m_aux_scores"] = tuple(per[n_aux:])
        return Sam3Detections(boxes_cxcywh=dec.boxes,
                              scores=scores_all[:, :Q],
                              mask_logits=masks_all[:, :Q],
                              embeddings=dec.queries, presence=pres_logit,
                              aux_boxes=dec.all_boxes, **extra)


# --------------------------------------------------------------------------
# converters of reference state dicts (the keys skix's converters read)
# --------------------------------------------------------------------------
def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(
        x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32))


def _convert_torch_mha(sd, prefix: str) -> dict[str, torch.Tensor]:
    """torch ``nn.MultiheadAttention`` (packed ``in_proj``) → the
    ``q``/``k``/``v``/``out`` leaves of :class:`_MHA`, relative to it."""
    w, b = _t(sd[f"{prefix}.in_proj_weight"]), _t(sd[f"{prefix}.in_proj_bias"])
    C = w.shape[1]
    out = {}
    for i, name in enumerate("qkv"):
        out[f"{name}.weight"] = w[i * C:(i + 1) * C]
        out[f"{name}.bias"] = b[i * C:(i + 1) * C]
    out["out.weight"] = _t(sd[f"{prefix}.out_proj.weight"])
    out["out.bias"] = _t(sd[f"{prefix}.out_proj.bias"])
    return out


def convert_fusion_encoder_layer(sd, prefix: str = "") -> dict:
    """The reference's pre-norm ``TransformerEncoderLayer`` (positions at
    attention) state dict → a :class:`FusionEncoderLayer` ``state_dict``."""
    out = {}
    for name in ("norm1", "norm2", "norm3"):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = _t(sd[f"{prefix}{name}.{leaf}"])
    for name in ("self_attn", "cross_attn_image"):
        out.update({f"{name}.{k}": v for k, v in
                    _convert_torch_mha(sd, f"{prefix}{name}").items()})
    for name in ("linear1", "linear2"):
        for leaf in ("weight", "bias"):
            out[f"ffn.{name}.{leaf}"] = _t(sd[f"{prefix}{name}.{leaf}"])
    return out


def convert_fusion_encoder(sd, num_layers: int = 6) -> dict:
    """The reference's fusion encoder stack (``layers.{i}.*``) → a
    :class:`FusionEncoder` ``state_dict``."""
    return {f"layer_{i}.{k}": v for i in range(num_layers)
            for k, v in convert_fusion_encoder_layer(
                sd, f"layers.{i}.").items()}
