"""skix_torch's Qwen2 text tower, Qwen2.5-VL vision tower and multimodal
splice against skix's, on the CPU at small widths.

skix's variables are drawn from a seeded numpy generator
(``_torch_parity.random_variables``, the RMSNorm weights near 1) and carried
into the port by ``skix_torch.convert``; both see the same numpy inputs.
skix's programs are compiled once each (``jit0``).

Tolerances: the text tower (GQA, with and without a padding mask, 1D and
M-RoPE), the vision tower (window blocks and a full block), the VL splice
1e-4 of the largest element where that exceeds 1; the M-RoPE tables 1e-6;
the positions, the patch layout, the converters and the tokenizer ids
exactly; ``preprocess_image_qwen`` on a 1080p frame (jax's antialiased
bilinear) 1e-4.
"""

import functools
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0, random_variables

from skix.models import qwen_text as ST
from skix.models import qwen_vl as SV
from skix_torch.convert import flax_to_state_dict, load_into
from skix_torch.models import qwen_text as PT
from skix_torch.models import qwen_vl as PV

rng = np.random.default_rng(4646)
VOCAB, HID, SEC = 300, 64, (2, 3, 3)       # head dim 16: half 8
VS, VE, PAD = 297, 298, 299
TEXT_KW = dict(vocab_size=VOCAB, hidden=HID, layers=2, heads=4, kv_heads=2,
               intermediate=128)
VIS_KW = dict(depth=3, hidden=32, heads=2, intermediate=64, out_hidden=HID,
              patch_size=4, window_size=16, fullatt_block_indexes=(1,))
GRID = (1, 16, 12)                          # 3 × 2 windows of 2 × 2 units


def _vars(module, *inputs, **kw):
    """random_variables with the towers' RMSNorm ``weight``s near 1."""
    v = random_variables(module, rng, *inputs, **kw)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (1.0 + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32) if p[-1].key == "weight" else a, v)


def _port(module, variables):
    assert not load_into(module, flax_to_state_dict(variables))
    return module.eval()


STEXT = ST.QwenTextEncoder(**TEXT_KW)
SVIS = SV.QwenVisionTower(**VIS_KW)
N_PATCH = GRID[0] * GRID[1] * GRID[2]


@functools.cache
def _towers():
    """skix's variables of both towers and the port's towers carrying them
    (built on first use, not while a worker collects): (text variables,
    text tower, vision variables, vision tower)."""
    tv = _vars(STEXT, jnp.zeros((1, 8), jnp.int32))
    vv = _vars(SVIS, jnp.zeros((N_PATCH, 96)), grid_thw=(GRID,))
    return (tv, _port(PT.QwenTextEncoder(**TEXT_KW), tv), vv,
            _port(PV.QwenVisionTower(**VIS_KW), vv))


def test_text_tower_gqa_and_padding_mask():
    tvars, text, _, _ = _towers()
    ids = rng.integers(0, VOCAB, size=(2, 10))
    mask = np.ones((2, 10), bool)
    mask[1, 6:] = False
    fn = jit0(STEXT.apply)
    with torch.no_grad():
        got_m = text(torch.as_tensor(ids), torch.as_tensor(mask))
        got = text(torch.as_tensor(ids))
    close_scaled(got_m.numpy(), fn(tvars, ids, mask), 1e-4)
    close_scaled(got.numpy(), fn(tvars, ids), 1e-4)
    assert not np.allclose(got_m.numpy()[1], got.numpy()[1])


def _vl_ids(text_len=6):
    n = N_PATCH // 4
    text = rng.integers(0, VS, size=text_len)
    return np.concatenate([rng.integers(0, VS, size=3), [VS],
                           np.full(n, PAD), [VE], text])[None]


def test_mrope_positions_and_tables():
    ids = _vl_ids()
    pos = PV.get_rope_index_images(ids, (GRID,), image_token_id=PAD,
                                   vision_start_token_id=VS)
    want = SV.get_rope_index_images(ids, (GRID,), image_token_id=PAD,
                                    vision_start_token_id=VS)
    np.testing.assert_array_equal(pos, want)
    assert pos[1].max() > pos[0, 0, 5]          # the image block is 2D
    cos, sin = PT._mrope_tables(torch.as_tensor(pos), 16, 1e6, SEC)
    wc, ws = ST._mrope_tables(pos, 16, 1e6, SEC)
    np.testing.assert_allclose(cos.numpy(), wc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), ws, rtol=0, atol=1e-6)


def test_static_tables_and_patch_layout():
    got = PV.vision_static_tables((GRID,), 16, 4, 16)
    want = SV.vision_static_tables((GRID,), 16, 4, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(np.unique(got[4], axis=0)) > 1          # several windows
    img = rng.normal(size=(16, 24, 3)).astype(np.float32)
    p, g = PV.patchify_image(img, 4)
    pw, gw = SV.patchify_image(img, 4)
    np.testing.assert_array_equal(p, pw)
    assert g == gw == (1, 4, 6)


def test_vision_tower_window_and_full_blocks():
    _, _, vvars, vis = _towers()
    patches = rng.normal(size=(N_PATCH, 96)).astype(np.float32)
    with torch.no_grad():
        got = vis(torch.as_tensor(patches), (GRID,))
    want = jit0(lambda v, x: SVIS.apply(v, x, (GRID,)))(vvars, patches)
    assert got.shape == (N_PATCH // 4, HID)
    close_scaled(got.numpy(), want, 1e-4)


def test_vl_splice():
    """The vision tokens spliced at the pads and the M-RoPE text tower, as
    skix's multimodal encode computes them (its jitted core, compiled once
    here)."""
    tvars, text, vvars, vis = _towers()
    ids = _vl_ids()
    patches = rng.normal(size=(N_PATCH, 96)).astype(np.float32)
    mask = np.ones(ids.shape, bool)
    mask[0, -2:] = False
    enc = PV.QwenVLEncoder(vis, text, mrope_section=SEC,
                           image_token_id=PAD, vision_start_token_id=VS)
    got = enc.encode(ids, patches, (GRID,), attention_mask=mask)
    flat_pos = np.flatnonzero(ids.reshape(-1) == PAD)
    pos = SV.get_rope_index_images(ids, (GRID,), image_token_id=PAD,
                                   vision_start_token_id=VS)
    core = SV._encode_core_mm.__wrapped__
    want = jit0(lambda v, i, p, f, q, m: core(SVIS, STEXT, SEC, (GRID,), v,
                                               i, p, f, q, m))(
        {"vision": vvars, "text": tvars}, ids, patches, flat_pos, pos, mask)
    close_scaled(got.numpy(), want, 1e-4)
    # the text-only path: sequential positions on all three components
    got_t = enc.encode(ids[:, -6:])
    want_t = jit0(lambda v, i, q: STEXT.apply(
        v, inputs_embeds=v["params"]["embed_tokens"]["embedding"][i],
        position_ids=q, mrope_section=SEC))(
        tvars, ids[:, -6:], np.broadcast_to(np.arange(6), (3, 1, 6)))
    close_scaled(got_t.numpy(), want_t, 1e-4)


def test_preprocess_a_1080p_frame():
    frame = rng.integers(0, 256, size=(1080, 1920, 3), dtype=np.uint8)
    p, g = PV.preprocess_image_qwen(frame, target_tokens=16)
    pw, gw = SV.preprocess_image_qwen(frame, target_tokens=16)
    assert g == gw == (1, 8, 8) and p.shape == pw.shape == (64, 1176)
    np.testing.assert_allclose(p, pw, rtol=0, atol=1e-4)
    # the same on a tensor (the stage's frame on its device)
    pt, _ = PV.preprocess_image_qwen(torch.as_tensor(frame), target_tokens=16)
    np.testing.assert_array_equal(pt.numpy(), p)


def _hf_text(sd_port, prefix):
    """The port's text state dict in HF Qwen2's layout under ``prefix``."""
    out = {}
    for k, t in sd_port.items():
        if k.startswith("layers_"):
            i, mod, leaf = k[7:].split(".")
            k = f"layers.{i}.{PT._LAYER_KEYS[mod]}.{leaf}"
        out[prefix + k] = t
    return out


def test_converters():
    _, text_tower, _, vis_tower = _towers()
    sd = text_tower.state_dict()
    text = {k: torch.as_tensor(rng.normal(size=tuple(t.shape)),
                               dtype=torch.float32) for k, t in sd.items()}
    hf = _hf_text(text, "model.")
    got = PT.convert_hf_qwen2(hf)
    want = flax_to_state_dict(ST.convert_hf_qwen2(hf))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    vis = {"patch_embed.proj.weight": (32, 3, 2, 4, 4),
           "merger.ln_q.weight": (32,), "merger.mlp.0.weight": (128, 128),
           "merger.mlp.0.bias": (128,), "merger.mlp.2.weight": (HID, 128),
           "merger.mlp.2.bias": (HID,)}
    for i in range(3):
        vis.update({f"blocks.{i}.norm1.weight": (32,),
                    f"blocks.{i}.norm2.weight": (32,)})
        for name, shape in (("attn.qkv", (96, 32)), ("attn.proj", (32, 32)),
                            ("mlp.gate_proj", (64, 32)),
                            ("mlp.up_proj", (64, 32)),
                            ("mlp.down_proj", (32, 64))):
            vis[f"blocks.{i}.{name}.weight"] = shape
            vis[f"blocks.{i}.{name}.bias"] = shape[:1]
    vis = {k: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
           for k, s in vis.items()}
    for vis_pre, txt_pre in (("model.visual.", "model.language_model."),
                             ("visual.", "model.")):
        full = {**{vis_pre + k: t for k, t in vis.items()},
                **_hf_text(text, txt_pre)}
        got = PV.convert_hf_qwen2_5_vl(full)
        want = SV.convert_hf_qwen2_5_vl(full)
        for part, port in (("vision", vis_tower), ("text", text_tower)):
            w = flax_to_state_dict(want[part])
            assert sorted(got[part]) == sorted(w) == sorted(
                port.state_dict()), part
            for k in w:
                np.testing.assert_array_equal(got[part][k].numpy(),
                                              w[k].numpy(), k)


def test_bpe_tokenizer(tmp_path):
    vocab = {c: i for i, c in enumerate(
        "abcdefghijklmnopqrstuvwxyzĠ0123456789.,!?'")}
    merges = ["#version: 0.2", "Ġ t", "h e", "Ġt he", "e r", "a m",
              "c am", "cam er", "camer a"]
    for m in merges[1:]:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(merges))
    args = (tmp_path / "vocab.json", tmp_path / "merges.txt")
    got = PT.QwenBpeTokenizer(*args, context_length=12)
    want = ST.QwenBpeTokenizer(*args, context_length=12)
    text = "rotate the camera 30 the. other, cam!"
    assert got.encode(text) == want.encode(text)
    assert got.decode(got.encode(text)) == text
    for g, w in zip(got([text, "the camera"]), want([text, "the camera"])):
        np.testing.assert_array_equal(g, w)
