"""skix_torch's Qwen-Image MMDiT against skix's, on the CPU at a small width.

The width is the published head dim on two heads: dim 256 = 2 × 128, rope
axes [16, 56, 56], depth 2, token grids ((1,4,4),(1,4,4)), 8 text tokens.
The port's weights are drawn from a seeded numpy generator
(``_torch_parity.port_variables``) and handed to skix through the inverse
bridge; both see the same numpy inputs. skix's programs are compiled once
at module scope (``jit0``).

Tolerances: the rope angles, packing, the schedule, the prompt helpers and
the converter exactly; the rope tables 1e-6; the block, the DiT and the
samplers 1e-4 of the largest element where that exceeds 1; K1's plain
version at the MMDiT's tables against skix's Pallas kernel (interpret
mode) 3e-5, the attention tests' f32 limit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0, port_variables

from skix.models import mmdit as S
from skix.ops.attention import flash_attention as skix_flash_attention
from skix.ops.attention import interleaved_rope_tables as skix_tables
from skix_torch.models import mmdit as P
from skix_torch.ops import attention as A

HEADS, HD, AXES, TXT = 2, 128, (16, 56, 56), 8
FHW = ((1, 4, 4), (1, 4, 4))
CIN, COUT = 64, 16
KW = dict(in_channels=CIN, out_channels=COUT, num_layers=2,
          attention_head_dim=HD, num_attention_heads=HEADS,
          joint_attention_dim=64, axes_dims_rope=AXES)

rng = np.random.default_rng(1313)
SDIT = S.QwenImageDiT(**KW)


@functools.cache
def _dit():
    """The port's DiT with seeded weights and the same weights as skix's
    variables (built on first use, not while a worker collects)."""
    dit = P.QwenImageDiT(**KW).eval()
    return dit, port_variables(dit, 5)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _dit_apply(v, x, emb, t):
    return SDIT.apply(v, x, emb, t, FHW)


SKIX_DIT = jit0(_dit_apply)


def _tokens(n=32, b=1):
    return rng.normal(size=(b, n, CIN)).astype(np.float32)


def _emb(b=1):
    return rng.normal(size=(b, TXT, 64)).astype(np.float32)


def test_rope_angles_and_tables():
    got = P.qwen_rope_angles(FHW, TXT, AXES)
    want = S.qwen_rope_angles(FHW, TXT, AXES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cos, sin = P.rope_tables(FHW, TXT, AXES, 10000.0, torch.device("cpu"))
    wc, ws = skix_tables(jnp.concatenate([jnp.asarray(want[1]),
                                          jnp.asarray(want[0])]))
    np.testing.assert_allclose(cos.numpy(), wc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), ws, rtol=0, atol=1e-6)
    # the text rows come first; the source image's frame position is 1
    assert cos.shape == (TXT + 32, HD)


def test_pack_unpack_and_sigmas():
    x = rng.normal(size=(2, 8, 6, 16)).astype(np.float32)
    packed = P.pack_latents(_t(x))
    np.testing.assert_array_equal(packed.numpy(), S.pack_latents(x))
    np.testing.assert_array_equal(P.unpack_latents(packed, 8, 6).numpy(), x)
    for steps, seq in ((4, 1024), (2, 16), (8, 4096)):
        np.testing.assert_array_equal(P.flow_match_sigmas(steps, seq),
                                      S.flow_match_sigmas(steps, seq))


def test_prompt_helpers():
    for kw in ({"rotate_deg": 30.0}, {"rotate_deg": -30.0, "wideangle": True},
               {"move_forward": -1.0, "vertical_tilt": 1.0}, {}):
        prompt = P.build_camera_prompt(**kw)
        assert prompt == S.build_camera_prompt(**kw)
        np.testing.assert_array_equal(
            P.embed_prompt_tokens(prompt, 16, 64),
            np.asarray(S.embed_prompt_tokens(prompt, 16, 64)))


def test_block():
    C = HEADS * HD
    blk = P.QwenImageBlock(HEADS, HD).eval()
    v = port_variables(blk, 6)
    img = rng.normal(size=(1, 32, C)).astype(np.float32)
    txt = rng.normal(size=(1, TXT, C)).astype(np.float32)
    temb = rng.normal(size=(1, C)).astype(np.float32)
    cos, sin = P.rope_tables(FHW, TXT, AXES, 10000.0, torch.device("cpu"))
    with torch.no_grad():
        gi, gt = blk(_t(img), _t(txt), _t(temb), cos, sin)
    wi, wt = jit0(S.QwenImageBlock(HEADS, HD).apply)(
        v, img, txt, temb, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
    close_scaled(gi.numpy(), wi, 1e-4)
    close_scaled(gt.numpy(), wt, 1e-4)


def test_dit():
    x, emb = _tokens(b=2), _emb(2)
    t = np.asarray([0.9, 0.3], np.float32)
    dit, variables = _dit()
    with torch.no_grad():
        got = dit(_t(x), _t(emb), _t(t), FHW)
    close_scaled(got.numpy(), SKIX_DIT(variables, x, emb, t), 1e-4)


def _skix_sampler(src: bool, cfg: bool):
    def run(v, lat, image_lat, emb, neg):
        return S.edit_plus_sample(
            SDIT, v, lat, image_lat if src else None, emb,
            FHW if src else FHW[:1],
            negative_prompt_emb=neg if cfg else None, true_cfg_scale=4.0,
            num_steps=2)
    return jit0(run)


@pytest.mark.parametrize("src,cfg", [(False, False), (True, False),
                                     (True, True)])
def test_edit_plus_sample(src, cfg):
    lat, image_lat = _tokens(16), _tokens(16)
    emb, neg = _emb(), _emb()
    dit, variables = _dit()
    with torch.no_grad():
        got = P.edit_plus_sample(
            dit, _t(lat), _t(image_lat) if src else None, _t(emb),
            FHW if src else FHW[:1],
            negative_prompt_emb=_t(neg) if cfg else None,
            true_cfg_scale=4.0, num_steps=2)
    want = _skix_sampler(src, cfg)(variables, lat, image_lat, emb, neg)
    close_scaled(got.numpy(), want, 1e-4)


def test_flow_matching_edit():
    lat, emb = _tokens(16), _emb()
    dit, variables = _dit()
    key = jax.random.PRNGKey(4)
    want = jit0(lambda v, x, e: S.flow_matching_edit(
        SDIT, v, x, e, FHW[:1], num_steps=2, key=key, strength=0.6))(
            variables, lat, emb)
    noise = jax.random.normal(key, lat.shape, jnp.float32)   # skix's draw
    with torch.no_grad():
        got = P.flow_matching_edit(dit, _t(lat), _t(emb), FHW[:1], _t(noise),
                                   num_steps=2, strength=0.6)
    close_scaled(got.numpy(), want, 1e-4)


def test_converter_matches_skix_and_the_bridge():
    from skix_torch.convert import flax_to_state_dict

    r = np.random.default_rng(8)
    ref = {}
    sd = P.QwenImageDiT(**KW).state_dict()
    for port, t in sd.items():
        mod, leaf = port.rsplit(".", 1)
        parts = mod.split(".")
        if parts[0].startswith("blocks_"):
            name = parts[1]
            sub = (P._BLOCK_KEYS.get(name) or P._BLOCK_NORMS[name])
            mod = f"transformer_blocks.{parts[0][7:]}.{sub}"
        else:
            mod = {"time_text_embed.linear_1":
                   "time_text_embed.timestep_embedder.linear_1",
                   "time_text_embed.linear_2":
                   "time_text_embed.timestep_embedder.linear_2",
                   "norm_out_linear": "norm_out.linear"}.get(mod, mod)
        ref[f"{mod}.{leaf}"] = torch.as_tensor(
            r.normal(size=tuple(t.shape)).astype(np.float32))
    got = P.convert_qwen_image_transformer(ref)
    want = flax_to_state_dict(S.convert_qwen_image_transformer(ref))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    with pytest.raises(ValueError, match="unconverted"):
        P.convert_qwen_image_transformer(
            {**ref, "pos_embed.weight": torch.zeros(2)})


def test_plain_k1_at_the_mmdit_tables():
    """K1's plain version with the MMDiT's interleaved tables (text rows
    first, a ragged 130 over 128-row tiles) against skix's kernel."""
    fhw = ((1, 4, 8), (1, 4, 8))          # 64 image tokens + 66 text
    q, k, v = (rng.normal(size=(1, 2, 130, HD)).astype(np.float32)
               for _ in range(3))
    cos, sin = P.rope_tables(fhw, 66, AXES, 10000.0, torch.device("cpu"))
    with torch.no_grad():
        got = A.flash_attention(_t(q), _t(k), _t(v), rope_cos=cos,
                                rope_sin=sin, rope_rotate="interleaved")
    want = skix_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        rope_cos=jnp.asarray(cos.numpy()), rope_sin=jnp.asarray(sin.numpy()),
        rope_rotate="interleaved", block_q=128, block_k_major=128,
        block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)
