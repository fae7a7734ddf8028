"""CLIP byte-pair-encoding tokenizer (open_clip/CLIP semantics).

A copy of ``skix/tracking/clip_tokenizer.py`` (it imports no JAX, but the
port imports nothing of skix): byte→unicode table, greedy lowest-rank BPE
merges with the ``</w>`` word-end marker, the CLIP token-split pattern,
``<start_of_text>``/``<end_of_text>`` specials, and fixed-context
padding/truncation with EOT at the end on overflow.

The merge table is the port's own copy, ``skix_torch/assets/clip_bpe.npz``
(the same bytes as skix's asset), so the token ids are skix's.

The CLIP pattern needs the Unicode classes L and N from the ``regex`` module; on a
machine without it the pattern falls back to ``re`` classes, which split
ASCII text the same way and may split non-ASCII text otherwise.
:data:`PATTERN_MODULE` says which one this process uses.
"""

from __future__ import annotations

import functools
import html
import string
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

try:  # the CLIP pattern needs \p{L}/\p{N}; the regex module ships them
    import regex as re

    _PAT_BODY = (r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"
                 r"[^\s\p{L}\p{N}]+")
    PATTERN_MODULE = "regex"
except ImportError:  # a machine without the regex module
    import re

    _PAT_BODY = r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+"
    PATTERN_MODULE = "re"

DEFAULT_CONTEXT_LENGTH = 77
_ASSET = Path(__file__).resolve().parent.parent / "assets" / "clip_bpe.npz"


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte ↔ printable-unicode table (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    try:  # ftfy when present, as skix; optional
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize_text(text: str) -> str:
    """Lowercase + punctuation removal."""
    text = text.replace("_", " ")
    text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


def get_clean_fn(kind: str):
    if kind == "canonicalize":
        return lambda x: canonicalize_text(_basic_clean(x))
    if kind == "lower":
        return lambda x: _whitespace_clean(_basic_clean(x)).lower()
    if kind == "whitespace":
        return lambda x: _whitespace_clean(_basic_clean(x))
    raise ValueError(f"invalid clean fn {kind!r}")


def load_merges(path: Optional[Path] = None) -> List[tuple]:
    with np.load(path or _ASSET, allow_pickle=True) as z:
        return [tuple(m.split()) for m in z["merges"].tolist()]


class ClipTokenizer:
    """CLIP BPE tokenizer; ``__call__`` → (N, context_length) int32."""

    def __init__(self, merges: Optional[Sequence[tuple]] = None,
                 additional_special_tokens: Optional[List[str]] = None,
                 context_length: int = DEFAULT_CONTEXT_LENGTH,
                 clean: str = "lower"):
        merges = list(merges) if merges is not None else load_merges()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        special = ["<start_of_text>", "<end_of_text>"]
        if additional_special_tokens:
            special += additional_special_tokens
        vocab.extend(special)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {t: t for t in special}
        self.pat = re.compile("|".join(special) + "|" + _PAT_BODY,
                              re.IGNORECASE)
        self.vocab_size = len(self.encoder)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = self.clean_fn(text)
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        L = context_length or self.context_length
        out = np.zeros((len(texts), L), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot_token_id] + self.encode(text) \
                + [self.eot_token_id]
            if len(toks) > L:
                toks = toks[:L]
                toks[-1] = self.eot_token_id
            out[i, :len(toks)] = toks
        return out
