"""Qwen2-family text tower and its byte-level BPE tokenizer: the
image-edit prompt conditioning.

Port of ``skix/models/qwen_text.py``, with skix's parameter tree
(``embed_tokens``, ``layers_{i}.{input_layernorm, q_proj, k_proj, v_proj,
o_proj, post_attention_layernorm, gate_proj, up_proj, down_proj}``,
``norm``): RMSNorm (HF form, a ``weight``), SwiGLU MLP, grouped-query
attention with rotate-half rope from tables (1D, or the M-RoPE of
Qwen2.5-VL from (3, B, L) positions), causal with a padding mask. The
attention is plain softmax in skix and plain torch here: no kernel.

:func:`convert_hf_qwen2` maps an HF ``Qwen2Model`` state dict onto the
port's names. :class:`QwenBpeTokenizer` is the GPT-2-style byte-level BPE
with Qwen's pre-tokenizer over the public ``vocab.json``/``merges.txt``;
without the ``regex`` module the pattern falls back to ``re`` classes
(:data:`PATTERN_MODULE`), which split ASCII text the same way.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Dense, init_like_flax
from skix_torch.tracking.clip_tokenizer import bytes_to_unicode

try:
    import regex as _re

    # transformers' Qwen2 PRETOKENIZE_REGEX, verbatim
    PRETOKENIZE_REGEX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                         r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                         r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                         r"\s+(?!\S)|\s+")
    PATTERN_MODULE = "regex"
except ImportError:  # a machine without the regex module
    import re as _re

    PRETOKENIZE_REGEX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                         r"(?:[^\r\n\w]|_)?[^\W\d_]+|\d|"
                         r" ?(?:[^\s\w]|_)+[\r\n]*|\s*[\r\n]+|"
                         r"\s+(?!\S)|\s+")
    PATTERN_MODULE = "re"


class RMSNorm(nn.Module):
    """HF Qwen RMSNorm: ``x · rsqrt(E[x²] + eps)`` in float32, times
    ``weight``, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.to(torch.float32)
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight).to(x.dtype)


def _rope_tables(length: int, dim: int, theta: float):
    """1D rope tables ``(L, dim)`` (HF layout: the frequencies twice), as
    float32 numpy."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(length, dtype=np.float32)
    freqs = np.outer(t, inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


def rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def _mrope_tables(position_ids, dim: int, theta: float, mrope_section):
    """``(3, B, L)`` positions → per-sequence ``(B, L, dim)`` cos/sin with
    the t/h/w channel sections taken in turn (section i from component
    i % 3), as Qwen2.5-VL's ``apply_multimodal_rotary_pos_emb``."""
    if mrope_section is None:
        raise ValueError("position_ids (3, B, L) requires mrope_section")
    inv = torch.as_tensor(
        1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)),
        device=position_ids.device)
    freqs = position_ids.to(torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)               # (3, B, L, dim)
    cos, sin = torch.cos(emb), torch.sin(emb)
    out_c, out_s, start = [], [], 0
    for i, sec in enumerate(list(mrope_section) * 2):
        out_c.append(cos[i % 3, :, :, start:start + sec])
        out_s.append(sin[i % 3, :, :, start:start + sec])
        start += sec
    return torch.cat(out_c, dim=-1), torch.cat(out_s, dim=-1)


class QwenBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, kv_heads: int,
                 intermediate: int, rms_eps: float = 1e-6):
        super().__init__()
        hd = hidden // heads
        self.heads, self.kv_heads, self.hd = heads, kv_heads, hd
        self.input_layernorm = RMSNorm(hidden, rms_eps)
        self.q_proj = Dense(hidden, heads * hd)
        self.k_proj = Dense(hidden, kv_heads * hd)
        self.v_proj = Dense(hidden, kv_heads * hd)
        self.o_proj = Dense(heads * hd, hidden, bias=False)
        self.post_attention_layernorm = RMSNorm(hidden, rms_eps)
        self.gate_proj = Dense(hidden, intermediate, bias=False)
        self.up_proj = Dense(hidden, intermediate, bias=False)
        self.down_proj = Dense(intermediate, hidden, bias=False)

    def forward(self, x, cos, sin, bias):
        """``cos``/``sin`` (L, hd) or (B, L, hd); ``bias`` (B or 1, L, L)
        additive."""
        B, L, _ = x.shape
        nh, nkv, hd = self.heads, self.kv_heads, self.hd
        h = self.input_layernorm(x)
        q = self.q_proj(h).reshape(B, L, nh, hd)
        k = self.k_proj(h).reshape(B, L, nkv, hd)
        v = self.v_proj(h).reshape(B, L, nkv, hd)
        if cos.dim() == 2:
            cos, sin = cos[None], sin[None]
        cos, sin = cos[:, :, None], sin[:, :, None]
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        # GQA: the query heads grouped over each kv head (no repeat)
        g = nh // nkv
        qg = q.reshape(B, L, nkv, g, hd).permute(0, 2, 3, 1, 4)
        kg = k.permute(0, 2, 1, 3)[:, :, None]             # (B, nkv, 1, L, hd)
        vg = v.permute(0, 2, 1, 3)[:, :, None]
        logits = torch.matmul(qg, kg.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(logits + bias[:, None, None], dim=-1)
        out = torch.matmul(attn, vg)                       # (B, nkv, g, L, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, L, nh * hd)
        x = x + self.o_proj(out)
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class QwenTextEncoder(nn.Module):
    """Token ids ``(B, L)`` (or ``inputs_embeds``) → the last hidden states
    ``(B, L, hidden)`` after the final norm; ``position_ids (3, B, L)``
    with ``mrope_section`` switch on the multimodal rope."""

    def __init__(self, vocab_size: int = 49408, hidden: int = 64,
                 layers: int = 2, heads: int = 4, kv_heads: int = 2,
                 intermediate: int = 128, rope_theta: float = 1_000_000.0,
                 rms_eps: float = 1e-6):
        super().__init__()
        self.layers, self.heads, self.rope_theta = layers, heads, rope_theta
        self.embed_tokens = nn.Embedding(vocab_size, hidden)
        for i in range(layers):
            self.add_module(f"layers_{i}", QwenBlock(
                hidden, heads, kv_heads, intermediate, rms_eps))
        self.norm = RMSNorm(hidden, rms_eps)

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions (the embedding normal
        with variance 1/hidden, as flax's ``Embed``)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, RMSNorm):
                    m.weight.fill_(1.0)
            w = self.embed_tokens.weight
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        return self

    def forward(self, tokens=None, attention_mask=None, inputs_embeds=None,
                position_ids=None, mrope_section=None):
        emb = self.embed_tokens(tokens) if inputs_embeds is None \
            else inputs_embeds
        B, L = emb.shape[:2]
        hd = emb.shape[-1] // self.heads
        if position_ids is None:
            cos, sin = (torch.as_tensor(t, device=emb.device)
                        for t in _rope_tables(L, hd, self.rope_theta))
        else:
            cos, sin = _mrope_tables(position_ids, hd, self.rope_theta,
                                     mrope_section)
        keep = torch.ones((L, L), dtype=torch.bool,
                          device=emb.device).tril()[None]
        if attention_mask is not None:
            keep = keep & torch.as_tensor(attention_mask, dtype=torch.bool,
                                          device=emb.device)[:, None, :]
        bias = torch.where(keep, 0.0, -1e9)
        h = emb
        for i in range(self.layers):
            h = getattr(self, f"layers_{i}")(h, cos, sin, bias)
        return self.norm(h)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      np.float32)


_LAYER_KEYS = {"input_layernorm": "input_layernorm",
               "post_attention_layernorm": "post_attention_layernorm",
               "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
               "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
               "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
               "down_proj": "mlp.down_proj"}


def convert_hf_qwen2(state_dict, prefix: str = "model."
                     ) -> dict[str, torch.Tensor]:
    """HF ``Qwen2Model.state_dict()`` (or the ``prefix``-ed language tower
    of a larger model) → a :class:`QwenTextEncoder` ``state_dict``, the
    keys skix's converter reads (q/k/v with biases, the rest without)."""
    sd = {k[len(prefix):] if prefix and k.startswith(prefix) else k: v
          for k, v in state_dict.items()}
    out = {"embed_tokens.weight": sd["embed_tokens.weight"],
           "norm.weight": sd["norm.weight"]}
    i = 0
    while f"layers.{i}.input_layernorm.weight" in sd:
        for port, ref in _LAYER_KEYS.items():
            for leaf in ("weight", "bias"):
                key = f"layers.{i}.{ref}.{leaf}"
                if key in sd and (leaf == "weight"
                                  or port in ("q_proj", "k_proj", "v_proj")):
                    out[f"layers_{i}.{port}.{leaf}"] = sd[key]
        i += 1
    return {k: torch.as_tensor(_np(v)) for k, v in out.items()}


class QwenBpeTokenizer:
    """GPT-2-style byte-level BPE with Qwen's pre-tokenizer over the
    public ``vocab.json`` + ``merges.txt`` (no ``</w>`` word markers)."""

    def __init__(self, vocab_file, merges_file,
                 eos_token: str = "<|endoftext|>",
                 context_length: int = 64):
        self.encoder = json.loads(
            Path(vocab_file).read_text(encoding="utf-8"))
        self.decoder = {v: k for k, v in self.encoder.items()}
        merges = []
        for i, line in enumerate(
                Path(merges_file).read_text(encoding="utf-8").splitlines()):
            line = line.strip()
            if (i == 0 and line.startswith("#version:")) or not line:
                continue
            merges.append(tuple(line.split()))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pat = _re.compile(PRETOKENIZE_REGEX)
        self.eos_id = self.encoder.get(eos_token)
        self.context_length = context_length

    @functools.lru_cache(maxsize=8192)
    def _bpe(self, token: str) -> str:
        word = tuple(token)
        if len(word) == 1:
            return token
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
        return " ".join(word)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        return bytearray(self.byte_decoder[c]
                         for c in text).decode("utf-8", errors="replace")

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None):
        """Fixed ``(B, L)`` int32 id slots (eos-padded) and a bool
        attention mask: ``(ids, mask)``."""
        if isinstance(texts, str):
            texts = [texts]
        L = context_length or self.context_length
        pad = self.eos_id if self.eos_id is not None else 0
        ids = np.full((len(texts), L), pad, np.int32)
        mask = np.zeros((len(texts), L), bool)
        for i, t in enumerate(texts):
            e = self.encode(t)[:L]
            ids[i, :len(e)] = e
            mask[i, :len(e)] = True
        return ids, mask
