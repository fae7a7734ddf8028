"""SAM3-family open-vocabulary promptable detector.

Port of ``skix/tracking/sam3_detector.py``: ViT-Det backbone + SimpleFPN
neck (:mod:`skix_torch.tracking.vitdet`), the vision–language fusion
encoder, the query decoder with iterative box refinement, boxRPB attention
bias, presence token and DAC one-to-many training queries, dot-product
scoring against the pooled prompt (per decoder layer with
``with_aux_scores``), and the maskformer pixel decoder + mask predictor.
Without a text prompt the detector runs unconditioned on its learned
``null_prompt`` token, as skix's ``train_detector`` trains it.

Attention: an unbiased, unmasked self-attention of ``L ≥ flash_min_seq``
tokens (the fusion encoder's image self-attention, 5184 tokens of head
dim 32 at 1008 px) goes through the flash kernel K1 (and K3/K4 in the
backward); every other attention is a plain einsum/softmax, as in skix.

``rope_style="sam3"`` with the reference's ``pretrain_img_size`` (336) is
the trunk configuration that converted SAM3 weights need (the interleaved
rope through K1/K2, :mod:`skix_torch.tracking.vitdet`). The converters of
reference state dicts come beside each module:
:func:`skix_torch.tracking.vitdet.convert_vitdet_state_dict` for the
trunk, :func:`convert_fusion_encoder` here for the fusion encoder. The
geometry prompt encoder comes with a later slice: a call that needs it
raises.
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

_GEOMETRY_SLICE = "ROADMAP Queue 1 item 11 (the geometry prompts)"


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
    """Image + text prompt memory → promptable detections.

    ``full_size()`` is the reference configuration (1008 px, 1024×32
    ViT-Det, d_model 256, 200 queries, 6+6 layers); ``tiny()`` the test
    configuration of skix.

    ``null_prompt``: the model has the learned ``null_prompt`` token that
    an unconditioned call (no text memory) attends to. skix creates that
    parameter only when its ``init`` ran without a prompt, as
    ``train_detector``'s does, so a variables tree has it or not; the flag
    mirrors that. ``remat`` recomputes each trunk block in the backward
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
                 dtype: torch.dtype = torch.float32):
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
        return self

    def forward(self, images, text_memory=None, text_pad_mask=None,
                points=None, boxes=None, apply_dac: bool = False,
                with_aux_scores: bool = False, **geometry):
        """``images (B, H, W, 3)`` in [0, 1]; ``text_memory (B, L, d_model)``
        (CLIP resizer output, or the hash smoke embedding), or None for the
        unconditioned detector. ``apply_dac=True`` (training) adds the DAC
        one-to-many outputs; ``with_aux_scores=True`` (training) scores
        every decoder layer's queries through the shared scoring head."""
        if points is not None or boxes is not None or geometry:
            raise NotImplementedError(
                f"geometry prompts come with {_GEOMETRY_SLICE}")
        B = images.shape[0]
        trunk = self.backbone((images - 0.5) / 0.5)
        feats, poss = self.neck(trunk)
        f = feats[2]                 # the 1.0-scale level (stride = patch)
        h, w = f.shape[1], f.shape[2]
        src = f.reshape(B, h * w, self.d_model)
        pos = poss[2].reshape(1, h * w, self.d_model)
        if text_memory is not None:
            prompt = text_memory
            prompt_pad = (torch.zeros(text_memory.shape[:2], dtype=torch.bool,
                                      device=images.device)
                          if text_pad_mask is None else text_pad_mask)
        elif self.null_prompt is not None:  # a learned "detect anything"
            prompt = self.null_prompt.expand(B, 1, self.d_model)
            prompt_pad = torch.zeros((B, 1), dtype=torch.bool,
                                     device=images.device)
        else:
            raise ValueError("no text prompt, and this detector has no "
                             "null_prompt (build it with null_prompt=True)")
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
