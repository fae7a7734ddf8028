"""Qwen-Image double-stream DiT and its edit samplers.

Port of ``skix/models/mmdit.py``: the Qwen-Image-Edit denoiser
(``QwenImageTransformer2DModel``) with skix's parameter tree, so
``skix_torch.convert`` maps a skix variables tree onto it leaf by leaf.

- Double-stream blocks: per-stream modulation (one SiLU → Dense giving
  shift, scale and gate for both norms), LayerNorm without affine (eps
  1e-6), per-head RMSNorm on q and k, joint attention over the
  concatenated [text, image] tokens with the 3D rope in the interleaved
  convention, tanh-GELU MLPs.
- The joint attention goes through
  :func:`skix_torch.ops.attention.flash_attention` with
  ``rope_rotate="interleaved"``: on the card it launches K1 with the rope
  tables of :func:`rope_tables` (text rows first), on the CPU its plain
  version.
- :func:`edit_plus_sample` is the Edit-Plus loop (source tokens joined on
  the sequence axis each step, the velocity sliced back, true-CFG with the
  cond-norm rescale, the shifted flow-match schedule);
  :func:`flow_matching_edit` the SDEdit option. skix's ``fori_loop`` is a
  Python loop here.
- :func:`convert_qwen_image_transformer` maps a state dict of the vendored
  diffusers module onto the port's names (the layouts are torch's on both
  sides) and raises on a key it does not use.

As in the reference, ``encoder_hidden_states_mask`` is accepted and does
not reach the attention.
"""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Dense, LayerNorm, init_like_flax
from skix_torch.ops.attention import flash_attention, interleaved_rope_tables


# --------------------------------------------------------------------------
# latent packing (channels-last, the reference's (channel, py, px) order)
# --------------------------------------------------------------------------
def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """``(B, h, w, C)`` latents → ``(B, h/2·w/2, C·4)`` tokens."""
    B, h, w, C = x.shape
    x = x.reshape(B, h // 2, 2, w // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (h // 2) * (w // 2), C * 4)


def unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`pack_latents` → ``(B, h, w, C)``."""
    B, S, C4 = x.shape
    C = C4 // 4
    x = x.reshape(B, h // 2, w // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, h, w, C)


# --------------------------------------------------------------------------
# rope (scale_rope positions, text past the largest image extent)
# --------------------------------------------------------------------------
def qwen_rope_angles(video_fhw, txt_len: int, axes_dim=(16, 56, 56),
                     theta: float = 10000.0, scale_rope: bool = True):
    """Per-pair rotation angles of the joint sequence, computed in float64
    and returned as float32 numpy ``(S_img, D/2)`` and ``(L, D/2)``.

    ``video_fhw``: the ``(frames, height, width)`` token grids, target
    first. Image ``idx`` takes frame positions ``idx..idx+f-1``; height and
    width take the centred ``[-(ceil/2), floor/2)`` positions with
    ``scale_rope``; text positions start past the largest half-extent."""
    inv = [1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
           for d in axes_dim]
    img_parts = []
    max_vid = 0
    for idx, (f, h, w) in enumerate(video_fhw):
        pf = np.arange(idx, idx + f, dtype=np.float64)
        if scale_rope:
            ph = np.arange(-(h - h // 2), h // 2, dtype=np.float64)
            pw = np.arange(-(w - w // 2), w // 2, dtype=np.float64)
            max_vid = max(max_vid, h // 2, w // 2)
        else:
            ph = np.arange(h, dtype=np.float64)
            pw = np.arange(w, dtype=np.float64)
            max_vid = max(max_vid, h, w)
        af = np.broadcast_to((pf[:, None] * inv[0])[:, None, None, :],
                             (f, h, w, len(inv[0])))
        ah = np.broadcast_to((ph[:, None] * inv[1])[None, :, None, :],
                             (f, h, w, len(inv[1])))
        aw = np.broadcast_to((pw[:, None] * inv[2])[None, None, :, :],
                             (f, h, w, len(inv[2])))
        img_parts.append(
            np.concatenate([af, ah, aw], axis=-1).reshape(f * h * w, -1))
    img_angles = np.concatenate(img_parts, axis=0)
    pt = np.arange(max_vid, max_vid + txt_len, dtype=np.float64)
    txt_angles = np.concatenate([pt[:, None] * iv for iv in inv], axis=-1)
    return img_angles.astype(np.float32), txt_angles.astype(np.float32)


@functools.lru_cache(maxsize=16)
def rope_tables(video_fhw, txt_len: int, axes_dim, theta: float,
                device: torch.device):
    """The joint sequence's interleaved (cos, sin) tables ``(L + S_img,
    D)`` on ``device``, text rows first, built once per shape."""
    img, txt = qwen_rope_angles(video_fhw, txt_len, axes_dim, theta)
    ang = torch.as_tensor(np.concatenate([txt, img], axis=0), device=device)
    return interleaved_rope_tables(ang)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class RMSNorm(nn.Module):
    """``flax.linen.RMSNorm`` over the last axis: ``x · (rsqrt(E[x²] + eps)
    · scale)`` in float32 (its ``scale`` is the port's ``weight``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.to(torch.float32)
        mul = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return xf * (mul * self.weight)


def _no_affine_ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, 1e-6, use_scale=False, use_bias=False)


class QwenTimestepEmbed(nn.Module):
    """``Timesteps(256, flip_sin_to_cos, shift 0, scale 1000)`` → two
    Dense layers with a SiLU between; ``t`` is sigma."""

    def __init__(self, dim: int):
        super().__init__()
        half = 128
        self.register_buffer("freqs", torch.as_tensor(
            np.exp(-np.log(10000.0) * np.arange(half) / half),
            dtype=torch.float32), persistent=False)
        self.linear_1 = Dense(2 * half, dim)
        self.linear_2 = Dense(dim, dim)

    def forward(self, t):
        args = t.to(torch.float32)[:, None] * self.freqs[None] * 1000.0
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.linear_2(F.silu(self.linear_1(emb)))


class QwenImageBlock(nn.Module):
    """One double-stream block."""

    def __init__(self, num_heads: int, head_dim: int):
        super().__init__()
        C = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.img_mod = Dense(C, 6 * C)
        self.txt_mod = Dense(C, 6 * C)
        self.img_norm1, self.txt_norm1 = _no_affine_ln(C), _no_affine_ln(C)
        self.img_norm2, self.txt_norm2 = _no_affine_ln(C), _no_affine_ln(C)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_out", "to_add_out"):
            self.add_module(name, Dense(C, C))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            self.add_module(name, RMSNorm(head_dim))
        self.img_mlp_in = Dense(C, 4 * C)
        self.img_mlp_out = Dense(4 * C, C)
        self.txt_mlp_in = Dense(C, 4 * C)
        self.txt_mlp_out = Dense(4 * C, C)

    def forward(self, img, txt, temb, rope_cos, rope_sin):
        B, L, C = txt.shape
        S = img.shape[1]
        st = F.silu(temb)
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(
            st)[:, None].chunk(6, dim=-1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(
            st)[:, None].chunk(6, dim=-1)

        def heads(x):
            return x.reshape(B, x.shape[1], self.num_heads, self.head_dim)

        img_n = self.img_norm1(img) * (1 + i_sc1) + i_sh1
        txt_n = self.txt_norm1(txt) * (1 + t_sc1) + t_sh1
        qi = self.norm_q(heads(self.to_q(img_n)))
        ki = self.norm_k(heads(self.to_k(img_n)))
        vi = heads(self.to_v(img_n))
        qt = self.norm_added_q(heads(self.add_q_proj(txt_n)))
        kt = self.norm_added_k(heads(self.add_k_proj(txt_n)))
        vt = heads(self.add_v_proj(txt_n))

        # joint attention, [text, image] order, the rope in the kernel
        q = torch.cat([qt, qi], dim=1).transpose(1, 2)
        k = torch.cat([kt, ki], dim=1).transpose(1, 2)
        v = torch.cat([vt, vi], dim=1).transpose(1, 2)
        out = flash_attention(q, k, v, rope_cos=rope_cos, rope_sin=rope_sin,
                              rope_rotate="interleaved")
        out = out.transpose(1, 2).reshape(B, L + S, C)
        txt_att, img_att = out[:, :L], out[:, L:]

        img = img + i_g1 * self.to_out(img_att)
        txt = txt + t_g1 * self.to_add_out(txt_att)
        img_n2 = self.img_norm2(img) * (1 + i_sc2) + i_sh2
        img = img + i_g2 * self.img_mlp_out(
            F.gelu(self.img_mlp_in(img_n2), approximate="tanh"))
        txt_n2 = self.txt_norm2(txt) * (1 + t_sc2) + t_sh2
        txt = txt + t_g2 * self.txt_mlp_out(
            F.gelu(self.txt_mlp_in(txt_n2), approximate="tanh"))
        return img, txt


class QwenImageDiT(nn.Module):
    """The denoiser on packed latent tokens ``(B, S, in_channels)`` (target
    tokens first, then source tokens); returns ``patch²·out_channels``
    features a token."""

    def __init__(self, patch_size: int = 2, in_channels: int = 64,
                 out_channels: int = 16, num_layers: int = 4,
                 attention_head_dim: int = 32, num_attention_heads: int = 4,
                 joint_attention_dim: int = 64,
                 axes_dims_rope: Sequence[int] = (16, 8, 8),
                 theta: float = 10000.0):
        super().__init__()
        D = attention_head_dim
        if sum(axes_dims_rope) != D:
            raise ValueError(f"axes_dims_rope {tuple(axes_dims_rope)} must "
                             f"sum to {D}")
        inner = num_attention_heads * D
        self.num_layers = num_layers
        self.axes_dims_rope = tuple(int(a) for a in axes_dims_rope)
        self.theta = float(theta)
        self.img_in = Dense(in_channels, inner)
        self.txt_norm = RMSNorm(joint_attention_dim)
        self.txt_in = Dense(joint_attention_dim, inner)
        self.time_text_embed = QwenTimestepEmbed(inner)
        for i in range(num_layers):
            self.add_module(f"blocks_{i}",
                            QwenImageBlock(num_attention_heads, D))
        self.norm_out_linear = Dense(inner, 2 * inner)
        self.norm_out = _no_affine_ln(inner)
        self.proj_out = Dense(inner, patch_size ** 2 * out_channels)

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions (Dense kernels
        LeCun-normal, biases 0, norm scales 1)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, RMSNorm):
                    m.weight.fill_(1.0)
        return self

    def forward(self, hidden_states, encoder_hidden_states, timestep,
                video_fhw: Tuple[Tuple[int, int, int], ...],
                encoder_hidden_states_mask=None):
        del encoder_hidden_states_mask
        video_fhw = tuple(tuple(int(v) for v in s) for s in video_fhw)
        S = hidden_states.shape[1]
        L = encoder_hidden_states.shape[1]
        if S != sum(f * h * w for f, h, w in video_fhw):
            raise ValueError(f"token count {S} != video_fhw {video_fhw}")
        img = self.img_in(hidden_states)
        txt = self.txt_in(self.txt_norm(encoder_hidden_states))
        temb = self.time_text_embed(timestep)
        cos, sin = rope_tables(video_fhw, L, self.axes_dims_rope, self.theta,
                               hidden_states.device)
        for i in range(self.num_layers):
            img, txt = getattr(self, f"blocks_{i}")(img, txt, temb, cos, sin)
        # AdaLayerNormContinuous: scale first, then shift
        scale, shift = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)
        img = self.norm_out(img) * (1 + scale[:, None]) + shift[:, None]
        return self.proj_out(img)


# --------------------------------------------------------------------------
# converter (the vendored diffusers module → the port's names)
# --------------------------------------------------------------------------
_BLOCK_KEYS = {
    "img_mod": "img_mod.1", "txt_mod": "txt_mod.1",
    "to_q": "attn.to_q", "to_k": "attn.to_k", "to_v": "attn.to_v",
    "add_q_proj": "attn.add_q_proj", "add_k_proj": "attn.add_k_proj",
    "add_v_proj": "attn.add_v_proj", "to_out": "attn.to_out.0",
    "to_add_out": "attn.to_add_out", "img_mlp_in": "img_mlp.net.0.proj",
    "img_mlp_out": "img_mlp.net.2", "txt_mlp_in": "txt_mlp.net.0.proj",
    "txt_mlp_out": "txt_mlp.net.2",
}
_BLOCK_NORMS = {"norm_q": "attn.norm_q", "norm_k": "attn.norm_k",
                "norm_added_q": "attn.norm_added_q",
                "norm_added_k": "attn.norm_added_k"}


def convert_qwen_image_transformer(state_dict) -> dict[str, torch.Tensor]:
    """A ``QwenImageTransformer2DModel`` state dict → a
    :class:`QwenImageDiT` ``state_dict`` (float32, the reference's keys
    skix's converter reads). Raises ``ValueError`` on a key it does not
    use, so a checkpoint converts whole or fails loudly."""
    sd = {k: torch.as_tensor(np.asarray(
        v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32))
        for k, v in state_dict.items()}
    used: set = set()
    out: dict[str, torch.Tensor] = {}

    def take(port, ref, leaves=("weight", "bias")):
        for leaf in leaves:
            used.add(f"{ref}.{leaf}")
            out[f"{port}.{leaf}"] = sd[f"{ref}.{leaf}"]

    for port, ref in (("img_in", "img_in"), ("txt_in", "txt_in"),
                      ("time_text_embed.linear_1",
                       "time_text_embed.timestep_embedder.linear_1"),
                      ("time_text_embed.linear_2",
                       "time_text_embed.timestep_embedder.linear_2"),
                      ("norm_out_linear", "norm_out.linear"),
                      ("proj_out", "proj_out")):
        take(port, ref)
    take("txt_norm", "txt_norm", ("weight",))
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("transformer_blocks."))
    for i in range(n_layers):
        for port, ref in _BLOCK_KEYS.items():
            take(f"blocks_{i}.{port}", f"transformer_blocks.{i}.{ref}")
        for port, ref in _BLOCK_NORMS.items():
            take(f"blocks_{i}.{port}", f"transformer_blocks.{i}.{ref}",
                 ("weight",))
    unmatched = sorted(set(sd) - used)
    if unmatched:
        raise ValueError(f"unconverted reference keys: {unmatched[:8]}"
                         f"{'...' if len(unmatched) > 8 else ''}")
    return out


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------
def flow_match_sigmas(num_steps: int, image_seq_len: int,
                      base_image_seq_len: int = 256,
                      max_image_seq_len: int = 4096,
                      base_shift: float = 0.5, max_shift: float = 1.15
                      ) -> np.ndarray:
    """The dynamically shifted flow-match schedule: ``linspace(1, 1/N)``
    through the exponential time shift at ``mu(seq_len)``, computed in
    float64, cast to float32, with a terminal 0."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
    m = (max_shift - base_shift) / (max_image_seq_len - base_image_seq_len)
    mu = image_seq_len * m + base_shift - m * base_image_seq_len
    shifted = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    return np.append(shifted, 0.0).astype(np.float32)


def _step(sig: np.ndarray, i: int) -> float:
    """sig[i + 1] − sig[i] in float32, as skix's schedule array gives it."""
    return float(np.float32(sig[i + 1]) - np.float32(sig[i]))


def edit_plus_sample(model: QwenImageDiT, latents, image_latents, prompt_emb,
                     video_fhw, *, negative_prompt_emb=None,
                     true_cfg_scale: float = 4.0, num_steps: int = 4,
                     sigmas=None):
    """The Edit-Plus loop: ``latents (B, S_tgt, C)`` start as noise; each
    step the source tokens ``image_latents (B, S_src, C)`` (or None) join
    on the sequence axis, the velocity is sliced back to the target tokens,
    true-CFG (with negative embeds and a scale above 1) combines both
    predictions with the cond-norm rescale, and an Euler step follows the
    shifted schedule."""
    S_tgt = latents.shape[1]
    sig = np.asarray(flow_match_sigmas(num_steps, S_tgt) if sigmas is None
                     else sigmas, np.float32)
    do_cfg = negative_prompt_emb is not None and true_cfg_scale > 1.0
    x = latents
    for i in range(len(sig) - 1):
        x_in = x if image_latents is None else torch.cat(
            [x, image_latents], dim=1)
        t = torch.full((x.shape[0],), float(sig[i]), dtype=x.dtype,
                       device=x.device)
        v = model(x_in, prompt_emb, t, video_fhw)[:, :S_tgt]
        if do_cfg:
            v_neg = model(x_in, negative_prompt_emb, t, video_fhw)[:, :S_tgt]
            comb = v_neg + true_cfg_scale * (v - v_neg)
            cond_norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            comb_norm = torch.linalg.vector_norm(comb, dim=-1, keepdim=True)
            v = comb * (cond_norm / comb_norm)
        x = x + _step(sig, i) * v
    return x


def flow_matching_edit(model: QwenImageDiT, latents, prompt_emb, video_fhw,
                       noise, num_steps: int = 4, strength: float = 1.0):
    """The SDEdit option: the packed source tokens noised with ``noise`` to
    ``t0 = strength``, then Euler steps of the velocity back to 0."""
    t0 = strength
    x = (1.0 - t0) * latents + t0 * noise
    ts = torch.linspace(t0, 0.0, num_steps + 1, dtype=torch.float32).numpy()
    for i in range(num_steps):
        t = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32,
                       device=x.device)
        x = x + _step(ts, i) * model(x, prompt_emb, t, video_fhw)
    return x


# --------------------------------------------------------------------------
# the camera-motion prompt and the smoke-only hash embedding
# --------------------------------------------------------------------------
def build_camera_prompt(rotate_deg: float = 0.0, move_forward: float = 0.0,
                        vertical_tilt: float = 0.0,
                        wideangle: bool = False) -> str:
    """Camera-motion controls → the bilingual edit prompt."""
    parts = []
    if abs(rotate_deg) > 0:
        side = "left" if rotate_deg > 0 else "right"
        side_zh = "左" if rotate_deg > 0 else "右"
        parts.append(f"Rotate the camera {abs(rotate_deg):.0f} degrees to "
                     f"the {side} 将镜头向{side_zh}旋转{abs(rotate_deg):.0f}度")
    if abs(move_forward) > 0:
        if move_forward > 0:
            parts.append("Move the camera forward 镜头前移")
        else:
            parts.append("Move the camera backward 镜头后移")
    if abs(vertical_tilt) > 0:
        if vertical_tilt > 0:
            parts.append("Tilt the camera upward 镜头上仰")
        else:
            parts.append("Tilt the camera downward 镜头下俯")
    if wideangle:
        parts.append("Switch to a wide-angle lens 切换到广角镜头")
    if not parts:
        parts.append("Keep the camera unchanged 保持镜头不变")
    return "; ".join(parts)


def embed_prompt_tokens(text: str, length: int = 16, dim: int = 64
                        ) -> np.ndarray:
    """Deterministic hash-seeded per-token embedding ``(length, dim)``
    float32: the stand-in behind ``smoke_text: true``."""
    toks = (text.lower().split() + ["<pad>"] * length)[:length]
    rows = []
    for tok in toks:
        h = hashlib.sha256(tok.encode()).digest()
        r = np.random.default_rng(int.from_bytes(h[:8], "little"))
        rows.append(r.normal(size=(dim,)).astype(np.float32))
    emb = np.stack(rows)
    return (emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-9)
            ).astype(np.float32)
