"""Mask-memory video tracker (SAM2-family), fixed-capacity ring memory.

Port of ``skix/tracking/memory_tracker.py``. Per tracked object a bank of
encoded (frame-feature, mask) memories conditions the current frame
through cross-attention, producing the object's mask logits and an
objectness score. The frame trunk is the conv pyramid or, with
``trunk='vitdet'``, the detector's ViT-Det backbone
(:func:`convert_tracker_trunk` reads a reference trunk into it).

skix runs one object bank per call and ``vmap``s the object slots; here the
object slots are a leading batch axis of every bank field
(``mem (K, M, gh, gw, C)``, ``valid (K, M)``, ``ring_pos (K,)``) and the
frame features, shared by every object, keep a batch of 1. The memory
attention's first layer therefore projects the shared query once and hands
the kernel a q of batch stride 0 (no K copies).

The dense memory attention (the front path's default) treats each bank as
one flat key/value sequence of M·L tokens, runs K1 with its base-2 lse
output and subtracts the closed-form softmax mass of the invalid slots,
whose tokens all equal the LayerNorm of the zero vector. The slot scan is
plain torch.

:func:`propagate_object` and :func:`propagate_objects` track objects
prompted by a first-frame mask through a clip (skix's streaming drivers):
each frame is encoded once, and the objects' banks go through the dense
memory attention as one batch, two K1 launches a frame (one a layer).
They run on the device of the model's weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Conv, Dense, GroupNorm, LayerNorm, Mlp,
                                      init_like_flax)
from skix_torch.ops.attention import _LOG2E, flash_attention_with_lse
from skix_torch.utils.image import resize


class ImageEncoder(nn.Module):
    """Frame trunk → ``(B, h, w, C)`` features. ``trunk='conv'`` (the front
    path's default): a stride-8 conv pyramid (3×3 stride-2 convs with
    flax's ``SAME`` padding, GroupNorm, SiLU). ``trunk='vitdet'``: the
    detector's windowed ViT-Det backbone (patch 14, 16 heads, 24 × 24
    windows, as skix's tracker builds it; its attention through K2 and K1
    on the card) on the frame mapped to [−1, 1], then a 1×1 ``proj`` to
    ``features``: stride 14."""

    def __init__(self, features: int = 64, trunk: str = "conv",
                 vit_embed_dim: int = 1024, vit_depth: int = 32):
        super().__init__()
        if trunk not in ("conv", "vitdet"):
            raise ValueError(f"trunk {trunk!r}: 'conv' or 'vitdet'")
        self.trunk = trunk
        if trunk == "vitdet":
            from skix_torch.tracking.vitdet import ViTDetBackbone

            self.vitdet = ViTDetBackbone(patch_size=14, embed_dim=vit_embed_dim,
                                         depth=vit_depth, num_heads=16,
                                         window_size=24)
            self.proj = Conv(vit_embed_dim, features, 1)
            return
        cin = 3
        for i, f in enumerate((features // 2, features, features)):
            self.add_module(f"conv_{i}", Conv(cin, f, 3, stride=2))
            self.add_module(f"norm_{i}", GroupNorm(8, f))
            cin = f

    def feature_hw(self, h: int, w: int) -> tuple[int, int]:
        """The feature grid of an ``h × w`` input."""
        if self.trunk == "vitdet":
            return h // 14, w // 14
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)
        return h, w

    def forward(self, image):
        if self.trunk == "vitdet":
            return self.proj(self.vitdet((image - 0.5) / 0.5))
        h = image.to(torch.float32)
        for i in range(3):
            h = F.silu(getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(h)))
        return h


def convert_tracker_trunk(sd) -> dict[str, torch.Tensor]:
    """A reference ViT-Det state dict (the keys
    :func:`skix_torch.tracking.vitdet.convert_vitdet_state_dict` reads) →
    the ``encoder.vitdet.*`` entries of a ``trunk='vitdet'``
    :class:`MaskMemoryTracker`'s ``state_dict``."""
    from skix_torch.tracking.vitdet import convert_vitdet_state_dict

    return {f"encoder.vitdet.{k}": v
            for k, v in convert_vitdet_state_dict(sd).items()}


class CXBlock(nn.Module):
    """ConvNeXt block: depthwise 7×7 conv → LayerNorm (eps 1e-6) → 1×1
    expand ×4 → GELU → 1×1 project → LayerScale → residual."""

    def __init__(self, dim: int, kernel_size: int = 7,
                 layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = Conv(dim, dim, kernel_size, groups=dim)
        self.norm = LayerNorm(dim, 1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))
        self.layer_scale_init = layer_scale_init

    def forward(self, x):
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + self.gamma * h


class MaskDownSampler(nn.Module):
    """Learned mask downsample: stride-``stride`` convs with channel growth
    stride², LayerNorm (eps 1e-6) + GELU, final 1×1 to ``embed_dim``."""

    def __init__(self, embed_dim: int = 64, stride: int = 4,
                 total_stride: int = 4):
        super().__init__()
        self.num_layers = int(math.log2(total_stride) // math.log2(stride))
        ch = 1
        for i in range(self.num_layers):
            self.add_module(f"conv_{i}", Conv(ch, ch * stride ** 2, stride,
                                              stride=stride, padding="VALID"))
            ch = ch * stride ** 2
            self.add_module(f"norm_{i}", LayerNorm(ch, 1e-6))
        self.out = Conv(ch, embed_dim, 1)

    def forward(self, m):
        for i in range(self.num_layers):
            m = F.gelu(getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(m)))
        return self.out(m)


class MemoryEncoder(nn.Module):
    """(frame features, mask logits) → one memory feature map: sigmoid mask
    → 4× bilinear upsample → learned downsample → added to the projected
    features → CXBlock fuser → output projection."""

    def __init__(self, features: int = 64, fuser_layers: int = 2):
        super().__init__()
        self.fuser_layers = fuser_layers
        self.mask_downsampler = MaskDownSampler(features)
        self.pix_feat_proj = Conv(features, features, 1)
        for i in range(fuser_layers):
            self.add_module(f"fuser_{i}", CXBlock(features))
        self.out_proj = Conv(features, features, 1)

    def forward(self, feats, mask_logits):
        """``feats (1 or K, gh, gw, C)``, ``mask_logits (K, h, w)`` at any
        resolution (the grid's, or a prompt's) → ``(K, gh, gw, C)``."""
        K = mask_logits.shape[0]
        gh, gw = feats.shape[-3], feats.shape[-2]
        m = torch.sigmoid(mask_logits)[..., None]
        m = resize(m, (K, gh * 4, gw * 4, 1), "bilinear")
        h = self.pix_feat_proj(feats) + self.mask_downsampler(m)
        for i in range(self.fuser_layers):
            h = getattr(self, f"fuser_{i}")(h)
        return self.out_proj(h)


class _SlotCrossAttention(nn.Module):
    """Cross-attention of query tokens over per-slot memory tokens; the
    flax names (``query``/``key``/``value``/``out`` DenseGenerals) are kept,
    their (C, H, hd) and (H, hd, C) kernels stored as 2-D weights."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value = (Dense(dim, dim) for _ in range(3))
        self.out = Dense(dim, dim)

    def forward(self, q_in, mem, slot_valid, pad_tok=None,
                dense: bool = False):
        """``q_in (1 or B, Lq, C)``; ``mem (B, M, L, C)``; ``slot_valid
        (B, M)`` bool; ``pad_tok (C,)`` the caller's LayerNorm of the zero
        vector (dense path only) → ``(B, Lq, C)``."""
        C = q_in.shape[-1]
        H = self.num_heads
        hd = C // H
        B, M, L = mem.shape[:3]
        Lq = q_in.shape[1]
        q = self.query(q_in).reshape(-1, Lq, H, hd) * (1.0 / math.sqrt(hd))
        k = self.key(mem).reshape(B, M, L, H, hd)
        v = self.value(mem).reshape(B, M, L, H, hd)
        qf = q.transpose(1, 2).expand(B, H, Lq, hd)
        if dense:
            kf = k.reshape(B, M * L, H, hd).transpose(1, 2)
            vf = v.reshape(B, M * L, H, hd).transpose(1, 2)
            out, lse = flash_attention_with_lse(qf, kf, vf, sm_scale=1.0)
            out = out.to(torch.float32)
            # subtract the invalid-slot mass r = n_inv·e^{q·k0} / Z
            k0 = self.key(pad_tok).reshape(H, hd).to(torch.float32)
            v0 = self.value(pad_tok).reshape(H, hd).to(torch.float32)
            n_inv = (L * (~slot_valid).sum(-1)).to(torch.float32)
            s0 = torch.einsum("bhqd,hd->bhq", qf.to(torch.float32), k0)
            r = n_inv[:, None, None] * torch.exp2(s0 * _LOG2E - lse)
            r = torch.clamp(r, max=1.0 - 1e-6)[..., None]
            out = (out - r * v0[None, :, None, :]) / (1.0 - r)
        else:
            m_run = torch.full((B, H, Lq), -1e30, device=mem.device)
            l_run = torch.zeros((B, H, Lq), device=mem.device)
            acc = torch.zeros((B, H, Lq, hd), device=mem.device)
            for s in range(M):
                sc = torch.einsum("bhqd,bkhd->bhqk", qf, k[:, s])
                ok = slot_valid[:, s][:, None, None, None]
                sc = torch.where(ok, sc, torch.full_like(sc, -1e30))
                m_new = torch.maximum(m_run, sc.amax(dim=-1))
                p = torch.where(ok, torch.exp(sc - m_new[..., None]),
                                torch.zeros_like(sc))
                corr = torch.exp(m_run - m_new)
                l_run = corr * l_run + p.sum(dim=-1)
                acc = corr[..., None] * acc + torch.einsum(
                    "bhqk,bkhd->bhqd", p, v[:, s])
                m_run = m_new
            out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        return self.out(out.transpose(1, 2).reshape(B, Lq, C))


class MemoryAttention(nn.Module):
    """Cross-attention of current-frame tokens over the memory bank tokens,
    ``layers`` pre-norm blocks of cross-attention + MLP."""

    def __init__(self, dim: int, num_heads: int = 4, layers: int = 2):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"norm_q_{i}", LayerNorm(dim, 1e-5))
            self.add_module(f"norm_kv_{i}", LayerNorm(dim, 1e-5))
            self.add_module(f"cross_{i}", _SlotCrossAttention(dim, num_heads))
            self.add_module(f"norm_mlp_{i}", LayerNorm(dim, 1e-5))
            self.add_module(f"mlp_{i}", Mlp(dim, 4 * dim))

    def forward(self, cur_tokens, mem, slot_valid, dense: bool = False):
        for i in range(self.layers):
            h = getattr(self, f"norm_q_{i}")(cur_tokens)
            ln_kv = getattr(self, f"norm_kv_{i}")
            pad_tok = (ln_kv(mem.new_zeros(mem.shape[-1])) if dense
                       else None)
            cur_tokens = cur_tokens + getattr(self, f"cross_{i}")(
                h, ln_kv(mem), slot_valid, pad_tok, dense)
            h2 = getattr(self, f"norm_mlp_{i}")(cur_tokens)
            cur_tokens = cur_tokens + getattr(self, f"mlp_{i}")(h2)
        return cur_tokens


class MaskDecoder(nn.Module):
    """Tokens → mask logits at feature resolution + objectness score."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.conv1 = Conv(features, features, 3)
        self.mask_out = Conv(features, 1, 1)
        self.score = Mlp(features, features, out_features=1)

    def forward(self, tokens, gh: int, gw: int):
        h = tokens.reshape(tokens.shape[0], gh, gw, tokens.shape[-1])
        mask = self.mask_out(F.silu(self.conv1(h)))[..., 0]
        score = self.score(tokens.mean(dim=1))[..., 0]
        return mask, score


class MemoryBank(NamedTuple):
    """Per object slot: the conditioning memory (slot 0, never evicted) +
    the recent ring. Every field has the object axis first."""

    mem: torch.Tensor        # (K, M, gh, gw, C)
    valid: torch.Tensor      # (K, M) bool
    ring_pos: torch.Tensor   # (K,) next recent slot to overwrite (1..M−1)


def init_memory(num_slots: int, gh: int, gw: int, c: int,
                num_objects: int = 1, device=None) -> MemoryBank:
    return MemoryBank(
        mem=torch.zeros((num_objects, num_slots, gh, gw, c), device=device),
        valid=torch.zeros((num_objects, num_slots), dtype=torch.bool,
                          device=device),
        ring_pos=torch.ones((num_objects,), dtype=torch.int64, device=device))


def write_conditioning(bank: MemoryBank, mem_feat) -> MemoryBank:
    """``mem_feat (K, gh, gw, C)`` into slot 0 of every object's bank."""
    mem = bank.mem.clone()
    valid = bank.valid.clone()
    mem[:, 0] = mem_feat
    valid[:, 0] = True
    return bank._replace(mem=mem, valid=valid)


def write_recent(bank: MemoryBank, mem_feat) -> MemoryBank:
    """``mem_feat (K, gh, gw, C)`` into each object's next ring slot."""
    M = bank.mem.shape[1]
    rows = torch.arange(bank.mem.shape[0], device=bank.mem.device)
    i = bank.ring_pos
    mem = bank.mem.clone()
    valid = bank.valid.clone()
    mem[rows, i] = mem_feat
    valid[rows, i] = True
    return MemoryBank(mem=mem, valid=valid,
                      ring_pos=torch.where(i + 1 >= M, torch.ones_like(i),
                                           i + 1))


class MaskMemoryTracker(nn.Module):
    """Per-object tracker: encode frame → memory cross-attention → mask
    decode → memory write, over K object banks at once."""

    def __init__(self, features: int = 64, num_heads: int = 1,
                 mem_slots: int = 4, trunk: str = "conv",
                 vit_embed_dim: int = 1024, vit_depth: int = 32):
        super().__init__()
        self.features, self.mem_slots = features, mem_slots
        self.encoder = ImageEncoder(features, trunk, vit_embed_dim, vit_depth)
        self.mem_encoder = MemoryEncoder(features)
        self.mem_attn = MemoryAttention(features, num_heads, 2)
        self.decoder = MaskDecoder(features)
        self.in_proj = Dense(features, features)

    def init_weights(self, generator=None):
        """Random weights in the distributions of flax's init (LayerScale
        gammas at their constant, the ViT-Det trunk's position table
        normal(0.02))."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, CXBlock):
                    m.gamma.fill_(m.layer_scale_init)
            if self.encoder.trunk == "vitdet":
                self.encoder.vitdet.pos_embed.normal_(0.0, 0.02,
                                                      generator=generator)
        return self

    def encode_frame(self, image):
        return self.encoder(image)

    def step(self, image, bank: MemoryBank, write: bool = True,
             dense: bool = False):
        """One frame ``image (1, H, W, 3)`` in [0, 1] for every object bank:
        returns ``(mask_logits (K, gh, gw), score (K,), new bank)``.
        ``dense=True``: the K1 memory attention (inference only)."""
        return self.step_from_feats(self.encoder(image), bank, write, dense)

    def step_dense(self, image, bank: MemoryBank, write: bool = True):
        """:meth:`step` on the dense memory attention."""
        return self.step_from_feats(self.encoder(image), bank, write,
                                    dense=True)

    def init_from_mask(self, image, mask, bank: MemoryBank) -> MemoryBank:
        """Condition each object on its prompted mask ``(K, H, W)`` (bool,
        any resolution) of frame ``image (1, H', W', 3)``: the mask as
        logits ±10 (mask·20 − 10), encoded and pinned to the conditioning
        slot."""
        feats = self.encoder(image)
        logits = torch.as_tensor(mask, device=feats.device).to(
            torch.float32) * 20.0 - 10.0
        return write_conditioning(bank, self.mem_encoder(feats, logits))

    def attend_decode(self, feats, bank: MemoryBank, dense: bool = False):
        """Memory cross-attention + mask decode without a memory write, for
        every object bank: ``feats (1, gh, gw, C)`` → ``(mask_logits (K, gh,
        gw), score (K,))``. An object with an empty bank attends to its zero
        slot 0 (uniform softmax over identical zero tokens)."""
        _, gh, gw, C = feats.shape
        cur = self.in_proj(feats.reshape(1, gh * gw, C))
        K, M = bank.valid.shape
        mem = bank.mem.reshape(K, M, gh * gw, bank.mem.shape[-1])
        first = torch.zeros_like(bank.valid)
        first[:, 0] = True
        slot_valid = torch.where(bank.valid.any(dim=1, keepdim=True),
                                 bank.valid, first)
        tok = self.mem_attn(cur, mem, slot_valid, dense=dense)
        return self.decoder(tok, gh, gw)

    def encode_memory(self, feats, mask_logits):
        """Memory encoder only: ``feats (1, gh, gw, C)`` + ``mask_logits
        (K, gh, gw)`` → ``(K, gh, gw, C)`` memory feature maps."""
        return self.mem_encoder(feats, mask_logits)

    def step_from_feats(self, feats, bank: MemoryBank, write: bool = True,
                        dense: bool = False):
        """Memory attention + decode + (optionally) a write of the encoded
        memory into each object's recent ring."""
        mask_logits, score = self.attend_decode(feats, bank, dense)
        if write:
            bank = write_recent(bank, self.encode_memory(feats, mask_logits))
        return mask_logits, score, bank


def _clip_on(model, frames):
    """``frames (T, H, W, 3)`` uint8 or float (numpy or a tensor) → a
    float32 tensor on the model's device, divided by 255 where its maximum
    exceeds 1.5 (skix's rule)."""
    frames = torch.as_tensor(frames).to(
        device=next(model.parameters()).device, dtype=torch.float32)
    if float(frames.max()) > 1.5:
        frames = frames / 255.0
    return frames


@torch.no_grad()
def propagate_object(model: MaskMemoryTracker, frames, first_mask,
                     mem_slots: int | None = None):
    """Track one object prompted by ``first_mask (H, W)`` bool at frame 0
    through ``frames (T, H, W, 3)``: returns numpy ``(mask_logits (T, gh,
    gw), scores (T,))``. Every frame, the first included, goes through
    :meth:`MaskMemoryTracker.step_dense` and writes its memory."""
    logits, scores = propagate_objects(model, frames,
                                       torch.as_tensor(first_mask)[None],
                                       mem_slots)
    return logits[:, 0], scores[:, 0]


@torch.no_grad()
def propagate_objects(model: MaskMemoryTracker, frames, first_masks,
                      mem_slots: int | None = None):
    """Track N objects prompted by ``first_masks (N, H, W)`` bool at frame
    0 through ``frames (T, H, W, 3)``: returns numpy ``(mask_logits (T, N,
    gh, gw), scores (T, N))``. The frame encoder runs once a frame; the N
    banks go through the memory attention together (skix ``vmap``s them)."""
    frames = _clip_on(model, frames)
    T = frames.shape[0]
    first_masks = torch.as_tensor(first_masks, device=frames.device)
    gh, gw = model.encoder.feature_hw(*frames.shape[1:3])
    bank = init_memory(mem_slots or model.mem_slots, gh, gw, model.features,
                       first_masks.shape[0], frames.device)
    bank = model.init_from_mask(frames[:1], first_masks, bank)
    masks, scores = [], []
    for t in range(T):
        m, s, bank = model.step_dense(frames[t:t + 1], bank)
        masks.append(m)
        scores.append(s)
    return (torch.stack(masks).cpu().numpy(),
            torch.stack(scores).cpu().numpy())
