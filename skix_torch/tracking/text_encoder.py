"""Byte-level text encoder for open-vocabulary prompts (CLIP-family).

Port of ``skix/tracking/text_encoder.py``: :func:`tokenize` (bytes with
BOS/EOS, padded with EOS), a causal transformer with learned positions
(flax ``MultiHeadDotProductAttention`` under a causal mask, in plain
torch: a few dozen tokens), the feature of the first EOS projected and
normalized (CLIP's EOT convention).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from skix_torch.models.layers import Dense, LayerNorm, Mlp

_VOCAB = 256 + 2  # bytes + BOS/EOS
_BOS = 256
_EOS = 257


def tokenize(text: str, max_len: int = 32) -> np.ndarray:
    """Byte-level tokens with BOS/EOS, padded with EOS; (max_len,) int32."""
    raw = list(text.lower().strip().encode("utf-8"))[: max_len - 2]
    toks = [_BOS] + raw + [_EOS]
    toks = toks + [_EOS] * (max_len - len(toks))
    return np.asarray(toks, np.int32)


def tokenize_batch(texts, max_len: int = 32) -> np.ndarray:
    return np.stack([tokenize(t, max_len) for t in texts])


class _CausalSelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (``query``/``key``/``value``/
    ``out``) of a sequence on itself under a boolean ``mask``: q scaled by
    1/√head_dim, masked logits set to the float32 minimum, softmax."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x, mask):
        B, L, C = x.shape
        H = self.num_heads
        hd = C // H
        q = self.query(x).reshape(B, L, H, hd) / np.sqrt(hd).astype(np.float32)
        k = self.key(x).reshape(B, L, H, hd)
        v = self.value(x).reshape(B, L, H, hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.where(mask, w, torch.finfo(w.dtype).min)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(w, dim=-1), v)
        return self.out(o.reshape(B, L, C))


class TextEncoder(nn.Module):
    """Causal transformer over byte tokens → ``(B, out_dim)`` unit prompt
    vectors."""

    def __init__(self, vocab: int = _VOCAB, max_len: int = 32, dim: int = 128,
                 depth: int = 2, num_heads: int = 4, out_dim: int = 64):
        super().__init__()
        self.max_len, self.depth = max_len, depth
        self.token_embed = nn.Embedding(vocab, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, dim))
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(dim, 1e-5))
            self.add_module(f"attn_{i}", _CausalSelfAttention(dim, num_heads))
            self.add_module(f"norm2_{i}", LayerNorm(dim, 1e-5))
            self.add_module(f"mlp_{i}", Mlp(dim, 4 * dim))
        self.final_norm = LayerNorm(dim, 1e-5)
        self.text_proj = Dense(dim, out_dim, bias=False)

    def forward(self, tokens):
        B, L = tokens.shape
        tokens = tokens.to(torch.int64)
        h = self.token_embed(tokens) + self.pos_embed[:, :L]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=h.device))
        for i in range(self.depth):
            a = getattr(self, f"norm1_{i}")(h)
            h = h + getattr(self, f"attn_{i}")(a, causal)
            h = h + getattr(self, f"mlp_{i}")(getattr(self, f"norm2_{i}")(h))
        h = self.final_norm(h)
        first_eos = torch.argmax((tokens == _EOS).to(torch.int32), dim=1)
        out = self.text_proj(h[torch.arange(B, device=h.device), first_eos])
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                      + 1e-6)


@torch.no_grad()
def encode_texts(model: TextEncoder, texts, max_len: int = 32):
    """``texts`` → ``(len(texts), out_dim)`` prompt vectors, on the model's
    device."""
    dev = next(model.parameters()).device
    return model(torch.as_tensor(tokenize_batch(texts, max_len), device=dev))
