"""Qwen2.5-VL vision tower and the multimodal prompt encoder.

Port of ``skix/models/qwen_vl.py``, with skix's parameter tree: the
image's patches run through the vision tower (window attention in every
block but ``fullatt_block_indexes``, rotary tables in HF's merge-unit
order, the RMSNorm → 4× concat → Linear/GELU/Linear merger, the output
back in the original merge-unit order), its tokens replace the
``<|image_pad|>`` positions of the prompt, and the text tower runs with
the 3D M-RoPE positions of :func:`get_rope_index_images`. The tower's
attention is plain softmax with an additive block mask in skix and plain
torch here: no kernel.

The static tables (window permutation, block masks, rotary tables) are
numpy copies of skix's. :func:`preprocess_image_qwen` resizes with
``skix_torch.utils.image.resize``, which follows ``jax.image.resize``'s
bilinear (antialiased when it downsamples), then CLIP-normalizes and
patchifies in HF's flattening order. :func:`convert_hf_qwen2_5_vl` maps
a ``Qwen2_5_VLForConditionalGeneration`` state dict onto the port's
names.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Dense, init_like_flax
from skix_torch.models.qwen_text import (QwenTextEncoder, RMSNorm,
                                         convert_hf_qwen2, rotate_half)
from skix_torch.utils.device import constant
from skix_torch.utils.image import resize


# ---------------------------------------------------------------------------
# static tables: rotary positions, window index, block masks
# ---------------------------------------------------------------------------
def _vision_rot_tables(grid_thw, head_dim: int, theta: float = 10000.0):
    """Per-token ``(L, head_dim)`` cos/sin at HF's merge-pattern order."""
    merge = 2
    pos_ids = []
    for t, h, w in grid_thw:
        hpos = np.arange(h)[:, None].repeat(w, 1)
        hpos = hpos.reshape(h // merge, merge, w // merge, merge)
        hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.arange(w)[None, :].repeat(h, 0)
        wpos = wpos.reshape(h // merge, merge, w // merge, merge)
        wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
        pos_ids.append(np.tile(np.stack([hpos, wpos], -1), (t, 1)))
    pos = np.concatenate(pos_ids, 0)
    dim = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    max_grid = max(max(h, w) for _, h, w in grid_thw)
    table = np.outer(np.arange(max_grid, dtype=np.float32), inv)
    freqs = table[pos].reshape(pos.shape[0], -1)
    emb = np.concatenate([freqs, freqs], -1)
    return np.cos(emb), np.sin(emb)


def _window_index(grid_thw, window_size: int, patch_size: int,
                  merge: int = 2):
    """HF ``get_window_index``: the window order of the merge units and
    each window's patch count (a full padding window where the grid
    divides, as HF pads)."""
    ws = window_size // merge // patch_size
    index_all, seqlens_all = [], []
    base = 0
    for t, h, w in grid_thw:
        lh, lw = h // merge, w // merge
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = ws - lh % ws
        pad_w = ws - lw % ws
        nh = (lh + pad_h) // ws
        nw = (lw + pad_w) // ws
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = idx
        padded = padded.reshape(t, nh, ws, nw, ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nh * nw, ws, ws)
        seqlens = (padded != -100).sum((2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        index_all.append(flat[flat != -100] + base)
        seqlens_all.append(seqlens * merge * merge)
        base += t * lh * lw
    return np.concatenate(index_all), np.concatenate(seqlens_all)


def _segment_mask(seg_lens, total: int) -> np.ndarray:
    """Block-diagonal boolean ``(total, total)`` from segment lengths."""
    seg = np.zeros(total, np.int64)
    ends = np.cumsum(seg_lens)
    starts = np.concatenate([[0], ends[:-1]])
    for i, (s, e) in enumerate(zip(starts, ends)):
        seg[s:e] = i
    return seg[:, None] == seg[None, :]


@functools.lru_cache(maxsize=16)
def vision_static_tables(grid_thw: Tuple[Tuple[int, int, int], ...],
                         window_size: int, patch_size: int, head_dim: int):
    """The tables of one grid: the patch-level window permutation, the
    inverse merge-unit permutation, cos/sin in window order, and the
    window and full additive masks (full attention is per frame, in the
    permuted order)."""
    merge = 2
    unit = merge * merge
    L = sum(t * h * w for t, h, w in grid_thw)
    cos, sin = _vision_rot_tables(grid_thw, head_dim)
    win_idx, win_seqlens = _window_index(grid_thw, window_size, patch_size,
                                         merge)
    patch_perm = (win_idx[:, None] * unit
                  + np.arange(unit)[None, :]).reshape(-1)
    cos, sin = cos[patch_perm], sin[patch_perm]
    mask_win = _segment_mask(win_seqlens, L)
    frame_lens = [h * w for t, h, w in grid_thw for _ in range(t)]
    seg = np.zeros(L, np.int64)
    ends = np.cumsum(frame_lens)
    starts = np.concatenate([[0], ends[:-1]])
    for i, (s, e) in enumerate(zip(starts, ends)):
        seg[s:e] = i
    seg = seg[patch_perm]
    mask_full = seg[:, None] == seg[None, :]
    rev_unit = np.argsort(win_idx)
    return (patch_perm, rev_unit, cos.astype(np.float32),
            sin.astype(np.float32),
            np.where(mask_win, 0.0, -1e9).astype(np.float32),
            np.where(mask_full, 0.0, -1e9).astype(np.float32))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class QwenVisionBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 rms_eps: float = 1e-6):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.norm1 = RMSNorm(hidden, rms_eps)
        self.qkv = Dense(hidden, 3 * hidden)
        self.proj = Dense(hidden, hidden)
        self.norm2 = RMSNorm(hidden, rms_eps)
        self.gate_proj = Dense(hidden, intermediate)
        self.up_proj = Dense(hidden, intermediate)
        self.down_proj = Dense(intermediate, hidden)

    def forward(self, x, cos, sin, bias):
        L = x.shape[0]
        nh = self.heads
        hd = self.hidden // nh
        q, k, v = self.qkv(self.norm1(x)).reshape(L, 3, nh, hd).unbind(1)
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        logits = torch.matmul(q.transpose(0, 1),
                              k.permute(1, 2, 0)) / math.sqrt(hd)
        attn = torch.softmax(logits + bias[None], dim=-1)
        out = torch.matmul(attn, v.transpose(0, 1))         # (nh, L, hd)
        x = x + self.proj(out.transpose(0, 1).reshape(L, self.hidden))
        h = self.norm2(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class QwenVisionTower(nn.Module):
    """HF-flattened patches ``(L, C·tps·ps²)`` and a static ``grid_thw`` →
    merged vision tokens ``(L/4, out_hidden)`` in the original merge-unit
    order."""

    def __init__(self, depth: int = 4, hidden: int = 64, heads: int = 4,
                 intermediate: int = 128, out_hidden: int = 64,
                 patch_size: int = 14, temporal_patch_size: int = 2,
                 in_channels: int = 3, window_size: int = 112,
                 fullatt_block_indexes: Tuple[int, ...] = (3,),
                 rms_eps: float = 1e-6):
        super().__init__()
        self.depth, self.hidden, self.heads = depth, hidden, heads
        self.patch_size, self.window_size = patch_size, window_size
        self.fullatt_block_indexes = tuple(int(i)
                                           for i in fullatt_block_indexes)
        self.patch_embed = Dense(
            in_channels * temporal_patch_size * patch_size ** 2, hidden,
            bias=False)
        for i in range(depth):
            self.add_module(f"blocks_{i}", QwenVisionBlock(
                hidden, heads, intermediate, rms_eps))
        self.ln_q = RMSNorm(hidden, rms_eps)
        self.mlp_0 = Dense(4 * hidden, 4 * hidden)
        self.mlp_2 = Dense(4 * hidden, out_hidden)

    def init_weights(self, generator=None):
        init_like_flax(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, RMSNorm):
                    m.weight.fill_(1.0)
        return self

    def forward(self, patches, grid_thw):
        grid_thw = tuple(tuple(int(v) for v in g) for g in grid_thw)
        L = patches.shape[0]
        dev = patches.device
        perm, rev_unit, cos, sin, mwin, mfull = (
            constant(t, dev) for t in vision_static_tables(
                grid_thw, self.window_size, self.patch_size,
                self.hidden // self.heads))
        x = self.patch_embed(patches.to(torch.float32))[perm]
        for i in range(self.depth):
            bias = mfull if i in self.fullatt_block_indexes else mwin
            x = getattr(self, f"blocks_{i}")(x, cos, sin, bias)
        x = self.ln_q(x).reshape(L // 4, 4 * self.hidden)
        x = self.mlp_2(F.gelu(self.mlp_0(x)))
        return x[rev_unit]


# ---------------------------------------------------------------------------
# the multimodal rope index (images only), HF get_rope_index
# ---------------------------------------------------------------------------
def get_rope_index_images(input_ids, image_grid_thw, *, image_token_id: int,
                          vision_start_token_id: int,
                          spatial_merge_size: int = 2) -> np.ndarray:
    """``(B, L)`` ids and each image's (t, h, w) grid → ``(3, B, L)`` t/h/w
    positions: text sequential, each image block constant-t with 2D h/w
    ids, every block offset to the running maximum + 1. No padding."""
    ids = np.asarray(input_ids)
    B, L = ids.shape
    out = np.zeros((3, B, L), np.int64)
    image_index = 0
    for b in range(B):
        tokens = ids[b].tolist()
        pos_list = []
        st = 0
        n_images = sum(
            1 for i in np.flatnonzero(ids[b] == vision_start_token_id)
            if i + 1 < L and ids[b][i + 1] == image_token_id)
        for _ in range(n_images):
            ed = tokens.index(image_token_id, st)
            t, h, w = (int(v) for v in image_grid_thw[image_index])
            image_index += 1
            lh, lw = h // spatial_merge_size, w // spatial_merge_size
            text_len = ed - st
            st_idx = (pos_list[-1].max() + 1) if pos_list else 0
            pos_list.append(
                np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
            t_idx = np.zeros(t * lh * lw, np.int64)
            h_idx = np.arange(lh)[None, :, None].repeat(t, 0) \
                .repeat(lw, 2).reshape(-1)
            w_idx = np.arange(lw)[None, None, :].repeat(t, 0) \
                .repeat(lh, 1).reshape(-1)
            pos_list.append(np.stack([t_idx, h_idx, w_idx])
                            + text_len + st_idx)
            st = ed + t * lh * lw
        if st < L:
            st_idx = (pos_list[-1].max() + 1) if pos_list else 0
            pos_list.append(
                np.broadcast_to(np.arange(L - st), (3, L - st)) + st_idx)
        out[:, b] = np.concatenate(pos_list, axis=1)
    return out


class QwenVLEncoder:
    """The vision tower and the text tower glued the reference way: vision
    tokens replace the ``<|image_pad|>`` positions, the text tower runs
    with the 3D rope, and the last hidden states come back ``(B, L,
    hidden)``. ``mrope_section`` sums to head_dim/2."""

    def __init__(self, vision: QwenVisionTower, text: QwenTextEncoder, *,
                 mrope_section, image_token_id: int,
                 vision_start_token_id: int):
        self.vision = vision
        self.text = text
        self.mrope_section = tuple(int(s) for s in mrope_section)
        self.image_token_id = int(image_token_id)
        self.vision_start_token_id = int(vision_start_token_id)

    @torch.no_grad()
    def encode(self, input_ids, patches=None, grid_thw=None,
               attention_mask=None):
        """``input_ids (B, L)``, optional ``patches (N, C·tps·ps²)`` with
        their static ``grid_thw`` → ``(B, L, hidden)`` on the towers'
        device."""
        ids = np.asarray(input_ids)
        dev = self.text.embed_tokens.weight.device
        B, L = ids.shape
        emb = self.text.embed_tokens(torch.as_tensor(ids, device=dev))
        if patches is not None:
            grid_thw = tuple(tuple(int(v) for v in g) for g in grid_thw)
            n_vis = sum(t * h * w for t, h, w in grid_thw) // 4
            flat_pos = np.flatnonzero(ids.reshape(-1) == self.image_token_id)
            if len(flat_pos) != n_vis:
                raise ValueError(f"{len(flat_pos)} <|image_pad|> tokens vs "
                                 f"{n_vis} vision tokens")
            pos = get_rope_index_images(
                ids, grid_thw, image_token_id=self.image_token_id,
                vision_start_token_id=self.vision_start_token_id)
            vis = self.vision(torch.as_tensor(patches, device=dev), grid_thw)
            emb = emb.reshape(B * L, -1).index_copy(
                0, torch.as_tensor(flat_pos, device=dev),
                vis.to(emb.dtype)).reshape(B, L, -1)
        else:
            pos = np.broadcast_to(np.arange(L), (3, B, L))
        mask = None if attention_mask is None else torch.as_tensor(
            np.asarray(attention_mask), device=dev)
        pos = torch.as_tensor(np.array(pos), device=dev)
        return self.text(inputs_embeds=emb, attention_mask=mask,
                         position_ids=pos, mrope_section=self.mrope_section)


# ---------------------------------------------------------------------------
# image → flattened patches (Qwen2VLImageProcessor layout)
# ---------------------------------------------------------------------------
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def patchify_image(img, patch_size: int = 14, merge: int = 2,
                   temporal_patch_size: int = 2):
    """``(H, W, 3)`` normalized float image (sides multiples of
    ``patch_size·merge``) → ``(patches (gh·gw, C·tps·ps²), grid (1, gh,
    gw))`` in HF's flattening order (a still image repeated
    ``temporal_patch_size`` times). Keeps a tensor's device; numpy in,
    float32 numpy out."""
    is_np = not isinstance(img, torch.Tensor)
    x = torch.as_tensor(np.asarray(img, np.float32)) if is_np \
        else img.to(torch.float32)
    H, W, C = x.shape
    ps, m, tps = patch_size, merge, temporal_patch_size
    if H % (ps * m) or W % (ps * m):
        raise ValueError(f"image {H}x{W} not a multiple of {ps * m}")
    gh, gw = H // ps, W // ps
    x = x.permute(2, 0, 1)[None].expand(tps, C, H, W)
    x = x.reshape(1, tps, C, gh // m, m, ps, gw // m, m, ps)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8).reshape(gh * gw,
                                                     C * tps * ps * ps)
    return (x.numpy() if is_np else x), (1, gh, gw)


def preprocess_image_qwen(img, patch_size: int = 14, merge: int = 2,
                          temporal_patch_size: int = 2,
                          target_tokens: int = 64):
    """``(H, W, 3)`` uint8 or float image (numpy, or a tensor on any
    device) → normalized HF patches and grid: resized (jax's bilinear,
    antialiased) to the square grid of ``target_tokens`` merged tokens,
    CLIP-normalized, patchified."""
    is_np = not isinstance(img, torch.Tensor)
    x = torch.as_tensor(np.asarray(img)) if is_np else img
    x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 \
        else x.to(torch.float32)
    side = int(round(float(np.sqrt(target_tokens)))) * patch_size * merge
    if tuple(x.shape[:2]) != (side, side):
        x = resize(x, (side, side, x.shape[2]), "bilinear")
    mean = torch.as_tensor(OPENAI_CLIP_MEAN, dtype=torch.float32,
                           device=x.device)
    std = torch.as_tensor(OPENAI_CLIP_STD, dtype=torch.float32,
                          device=x.device)
    patches, grid = patchify_image((x - mean) / std, patch_size, merge,
                                   temporal_patch_size)
    return (patches.numpy() if is_np else patches), grid


# ---------------------------------------------------------------------------
# HF converter
# ---------------------------------------------------------------------------
def convert_hf_qwen2_5_vl(state_dict) -> dict[str, dict[str, torch.Tensor]]:
    """A full ``Qwen2_5_VLForConditionalGeneration.state_dict()`` (the
    ``model.visual``/``model.language_model`` layout or the legacy
    ``visual``/``model.layers`` one) → ``{"vision": state_dict, "text":
    state_dict}`` of :class:`QwenVisionTower` and
    :class:`QwenTextEncoder`."""
    def t(x):
        return torch.as_tensor(np.asarray(
            x.detach().cpu().numpy() if hasattr(x, "detach") else x,
            np.float32))

    sd = dict(state_dict)
    vis_pre = ("model.visual." if any(k.startswith("model.visual.")
                                      for k in sd) else "visual.")
    vis = {k[len(vis_pre):]: v for k, v in sd.items()
           if k.startswith(vis_pre)}
    if any(k.startswith("model.language_model.") for k in sd):
        txt = {k[len("model.language_model."):]: v for k, v in sd.items()
               if k.startswith("model.language_model.")}
    else:
        txt = {k[len("model."):]: v for k, v in sd.items()
               if k.startswith("model.") and "visual" not in k}
    pe = t(vis["patch_embed.proj.weight"])
    out = {"patch_embed.weight": pe.reshape(pe.shape[0], -1),
           "ln_q.weight": t(vis["merger.ln_q.weight"])}
    for port, ref in (("mlp_0", "merger.mlp.0"), ("mlp_2", "merger.mlp.2")):
        out[f"{port}.weight"] = t(vis[f"{ref}.weight"])
        out[f"{port}.bias"] = t(vis[f"{ref}.bias"])
    i = 0
    while f"blocks.{i}.norm1.weight" in vis:
        bp = f"blocks.{i}"
        out[f"blocks_{i}.norm1.weight"] = t(vis[f"{bp}.norm1.weight"])
        out[f"blocks_{i}.norm2.weight"] = t(vis[f"{bp}.norm2.weight"])
        for port, ref in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                          ("gate_proj", "mlp.gate_proj"),
                          ("up_proj", "mlp.up_proj"),
                          ("down_proj", "mlp.down_proj")):
            out[f"blocks_{i}.{port}.weight"] = t(vis[f"{bp}.{ref}.weight"])
            out[f"blocks_{i}.{port}.bias"] = t(vis[f"{bp}.{ref}.bias"])
        i += 1
    return {"vision": out, "text": convert_hf_qwen2(txt, prefix="")}
