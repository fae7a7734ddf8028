"""CLIP text tower and the VE text encoder of the SAM3 prompt path.

Port of ``skix/tracking/clip_text.py``: pre-LN residual attention blocks
(torch ``nn.MultiheadAttention``'s packed ``in_proj`` layout), learned
positional embeddings, a causal mask, ``ln_final``, an optional text
projection, and ``VETextEncoder`` (width 1024, 16 heads, 24 layers,
context 32 in the reference configuration) whose ``resizer`` maps token
features to the detector's d_model. Submodules carry skix's flax names, so
``skix_torch.convert`` loads a skix checkpoint of it;
:func:`convert_ve_text_encoder` reads a reference state dict directly.

A prompt is 32 causal tokens: the attention is plain torch ops (f32 scores,
softmax, one product), as skix's is, and launches no kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Dense, LayerNorm, init_like_flax


class _TorchMHA(nn.Module):
    """Self-attention in the layout of torch's ``nn.MultiheadAttention``:
    one packed ``in_proj`` (q, k, v) and ``out_proj``."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)

    def forward(self, x, attn_bias=None):
        B, L, C = x.shape
        hd = C // self.heads
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2)
                   for t in self.in_proj(x).split(C, dim=-1))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        if attn_bias is not None:
            s = s + attn_bias
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ln_1 = LayerNorm(width, 1e-5)
        self.attn = _TorchMHA(width, heads)
        self.ln_2 = LayerNorm(width, 1e-5)
        self.c_fc = Dense(width, int(width * mlp_ratio))
        self.c_proj = Dense(int(width * mlp_ratio), width)

    def forward(self, x, attn_bias=None):
        x = x + self.attn(self.ln_1(x), attn_bias)
        return x + self.c_proj(F.gelu(self.c_fc(self.ln_2(x))))


class CLIPTextTower(nn.Module):
    """Token + positional embedding → causal transformer → ``ln_final``;
    returns ``(pooled, per-token features, input embeddings)``, the pool
    the argmax (EOT) token's feature for ``pool_type="argmax"``, the
    first's or last's for ``"first"``/``"last"``, every token's for
    ``"none"``, projected by ``text_projection`` when ``output_dim`` is
    set."""

    def __init__(self, context_length: int = 32, vocab_size: int = 49408,
                 width: int = 1024, heads: int = 16, layers: int = 24,
                 mlp_ratio: float = 4.0, output_dim: Optional[int] = None,
                 use_ln_post: bool = True, causal: bool = True,
                 pool_type: str = "none"):
        super().__init__()
        if pool_type not in ("none", "argmax", "first", "last"):
            raise ValueError(f"pool_type {pool_type!r}")
        self.layers, self.causal, self.pool_type = layers, causal, pool_type
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        for i in range(layers):
            self.add_module(f"resblock_{i}", _ResidualAttentionBlock(
                width, heads, mlp_ratio))
        self.ln_final = LayerNorm(width, 1e-5) if use_ln_post else None
        self.text_projection = (nn.Parameter(torch.zeros(width, output_dim))
                                if output_dim is not None else None)

    def forward(self, tokens):
        B, L = tokens.shape
        embeds = self.token_embedding(tokens.long())
        x = embeds + self.positional_embedding[:L]
        bias = None
        if self.causal:
            mask = torch.ones((L, L), dtype=torch.bool,
                              device=tokens.device).tril()
            bias = torch.zeros((L, L), device=tokens.device).masked_fill(
                ~mask, float("-inf"))[None, None]
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, bias)
        if self.ln_final is not None:
            x = self.ln_final(x)
        if self.pool_type == "argmax":
            pooled = x[torch.arange(B, device=x.device), tokens.argmax(-1)]
        elif self.pool_type == "first":
            pooled = x[:, 0]
        elif self.pool_type == "last":
            pooled = x[:, -1]
        else:
            pooled = x
        if self.text_projection is not None:
            pooled = pooled @ self.text_projection
        return pooled, x, embeds


class VETextEncoder(nn.Module):
    """Text tokens ``(B, L)`` → ``(attention_mask, resized token memory,
    input embeddings)`` for the fusion encoder; the mask is True for a
    valid token (token id ≠ 0), the detector's pad mask its negation."""

    def __init__(self, d_model: int = 256, width: int = 1024,
                 heads: int = 16, layers: int = 24, context_length: int = 32,
                 vocab_size: int = 49408):
        super().__init__()
        self.context_length = context_length
        self.encoder = CLIPTextTower(context_length, vocab_size, width,
                                     heads, layers)
        self.resizer = Dense(width, d_model)

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions: Dense kernels
        LeCun-normal, biases 0, norms 1/0; the token embedding normal with
        variance 1/width (flax's ``Embed``), the positional embedding
        normal(0.01)."""
        init_like_flax(self, generator)
        emb = self.encoder.token_embedding.weight
        with torch.no_grad():
            emb.normal_(0.0, emb.shape[1] ** -0.5, generator=generator)
            self.encoder.positional_embedding.normal_(0.0, 0.01,
                                                      generator=generator)
        return self

    def forward(self, tokens):
        _, text_memory, inputs_embeds = self.encoder(tokens)
        return tokens != 0, self.resizer(text_memory), inputs_embeds


def convert_ve_text_encoder(state_dict) -> dict[str, torch.Tensor]:
    """A reference ``VETextEncoder`` state dict (``encoder.token_embedding.
    weight``, ``encoder.positional_embedding``, ``encoder.transformer.
    resblocks.{i}.{ln_1,attn.in_proj_*,attn.out_proj,ln_2,mlp.c_fc,
    mlp.c_proj}``, ``encoder.ln_final``, ``encoder.text_projection``,
    ``resizer``) → a :class:`VETextEncoder` ``state_dict``, reading the keys
    skix's ``convert_ve_text_encoder`` reads. Torch layouts are the port's,
    so each tensor is copied under its new name."""
    def t(x):
        return torch.as_tensor(np.asarray(
            x.detach().cpu().numpy() if hasattr(x, "detach") else x,
            np.float32))

    sd = state_dict
    out = {"encoder.token_embedding.weight":
           t(sd["encoder.token_embedding.weight"]),
           "encoder.positional_embedding":
           t(sd["encoder.positional_embedding"])}
    names = {"ln_1": "ln_1", "ln_2": "ln_2", "attn.out_proj": "attn.out_proj",
             "mlp.c_fc": "c_fc", "mlp.c_proj": "c_proj"}
    i = 0
    while f"encoder.transformer.resblocks.{i}.ln_1.weight" in sd:
        pre = f"encoder.transformer.resblocks.{i}."
        for ref, port in names.items():
            for leaf in ("weight", "bias"):
                out[f"encoder.resblock_{i}.{port}.{leaf}"] = t(
                    sd[f"{pre}{ref}.{leaf}"])
        out[f"encoder.resblock_{i}.attn.in_proj.weight"] = t(
            sd[pre + "attn.in_proj_weight"])
        out[f"encoder.resblock_{i}.attn.in_proj.bias"] = t(
            sd[pre + "attn.in_proj_bias"])
        i += 1
    for key in ("encoder.ln_final.weight", "encoder.ln_final.bias",
                "encoder.text_projection"):
        if key in sd:
            out[key] = t(sd[key])
    out["resizer.weight"] = t(sd["resizer.weight"])
    out["resizer.bias"] = t(sd["resizer.bias"])
    return out
