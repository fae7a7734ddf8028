"""The compact promptable detector and the smoke-mode prompt embedding.

Port of ``skix/tracking/detector.py``: :class:`DetrDetector`, a ViT
encoder (the port's :class:`~skix_torch.models.layers.Block`, whose
attention runs through ``flash_attention``: K1 on the card) with the
projected prompt added to every token, learned object queries through
cross-attention decoder blocks (the port's ``CrossAttnBlock``), a sigmoid
cxcywh box head, scores against the prompt by dot product and
maskformer-style mask logits; and :func:`embed_text_prompt` (numpy,
copied as it is).
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from skix_torch.models.layers import (Block, Dense, LayerNorm, Mlp,
                                      PatchEmbed, init_like_flax)


class Detections(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, Q, 4) in pixels of the input image
    scores: torch.Tensor       # (B, Q)
    embeddings: torch.Tensor   # (B, Q, C) query features
    mask_logits: torch.Tensor  # (B, Q, gh, gw) per-query mask logits


class DetrDetector(nn.Module):
    """``images (B, H, W, 3)`` in [0, 1] + optional ``prompt_embedding (B,
    prompt_dim)`` → :class:`Detections`."""

    def __init__(self, img_size: int = 256, patch_size: int = 16,
                 embed_dim: int = 192, depth: int = 6, num_heads: int = 6,
                 num_queries: int = 16, decoder_depth: int = 2,
                 prompt_dim: int = 64):
        super().__init__()
        from skix_torch.models.sam3d_body import CrossAttnBlock

        self.img_size, self.patch_size = img_size, patch_size
        self.embed_dim, self.depth = embed_dim, depth
        self.num_queries, self.decoder_depth = num_queries, decoder_depth
        self.prompt_dim = prompt_dim
        C = embed_dim
        self.patch_embed = PatchEmbed(patch_size, C)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, (img_size // patch_size) ** 2, C))
        self.prompt_proj = Dense(prompt_dim, C)
        for i in range(depth):
            self.add_module(f"block_{i}", Block(C, num_heads, 4.0))
        self.enc_norm = LayerNorm(C, 1e-6)
        self.query_embed = nn.Parameter(torch.zeros(1, num_queries, C))
        for i in range(decoder_depth):
            self.add_module(f"decoder_{i}", CrossAttnBlock(C, num_heads))
        self.dec_norm = LayerNorm(C, 1e-6)
        self.box_head = Mlp(C, C, 4)
        self.objectness = Mlp(C, C, 1)
        self.score_proj = Dense(prompt_dim, C)
        self.pixel_embed = Dense(C, C)
        self.mask_embed = Mlp(C, C, C)

    def init_weights(self, generator=None):
        """flax's initializers: LeCun-normal kernels, zero biases, unit
        LayerNorms, position table and queries N(0, 0.02²)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
            self.query_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, images, prompt_embedding=None) -> Detections:
        B, H, W, _ = images.shape
        tokens = self.patch_embed((images - 0.5) / 0.5) + self.pos_embed
        if prompt_embedding is not None:
            tokens = tokens + self.prompt_proj(prompt_embedding)[:, None, :]
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
        memory = self.enc_norm(tokens)
        q = self.query_embed.expand(B, -1, -1)
        for i in range(self.decoder_depth):
            q = getattr(self, f"decoder_{i}")(q, memory)
        q = self.dec_norm(q)
        cx, cy, w, h = torch.sigmoid(self.box_head(q)).unbind(-1)
        boxes = torch.stack([(cx - w / 2) * W, (cy - h / 2) * H,
                             (cx + w / 2) * W, (cy + h / 2) * H], dim=-1)
        obj = self.objectness(q)[..., 0]
        if prompt_embedding is not None:
            pq = self.score_proj(prompt_embedding)
            sim = torch.einsum("bqc,bc->bq", q, pq) / math.sqrt(
                float(np.float32(self.embed_dim)))
            scores = torch.sigmoid(obj + sim)
        else:
            scores = torch.sigmoid(obj)
        gh, gw = H // self.patch_size, W // self.patch_size
        mask_logits = torch.einsum("bqc,bpc->bqp", self.mask_embed(q),
                                   self.pixel_embed(memory))
        return Detections(boxes_xyxy=boxes, scores=scores, embeddings=q,
                          mask_logits=mask_logits.reshape(
                              B, self.num_queries, gh, gw))


def embed_text_prompt(text: str, dim: int = 64) -> np.ndarray:
    """Deterministic hash-based concept embedding ``(dim,)`` float32, unit
    norm: the slot a CLIP text tower fills once its weights are in the
    repository. Distinct strings get near-orthogonal vectors."""
    h = hashlib.sha256(text.lower().strip().encode()).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
    v = rng.normal(size=(dim,)).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-9)
