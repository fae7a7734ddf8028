"""ViT-Det and Sam3Detector in the reference SAM3 configuration
(``rope_style="sam3"``) against skix, and the converters of reference state
dicts.

- ``ViTDetBackbone(rope_style="sam3")`` at the size of skix's converter test
  (img 56, pretrain 28, patch 14, embed 32, depth 2, heads 2, window 2,
  global block 1): the interleaved axial rope through the plain K2
  (windows) and K1 (global block), the pretrain-sized position table tiled;
- ``Sam3Detector.tiny(rope_style="sam3")``: the forward and one gradient;
- a synthetic state dict in the reference's layout (a cls entry in
  ``pos_embed``, no patch bias) through skix's converter and forward,
  against the port's converter and forward; the same for the fusion
  encoder's layers.

skix runs on the CPU through its XLA paths, the port through the plain
versions of the kernels: float32 sums in other orders, 1e-4 as
``tests/test_torch_sam3_detector.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import jit0, random_variables

from skix_torch.convert import (flax_to_state_dict, load_into,
                                state_dict_to_flax)

ATOL = 1e-4
VIT = dict(img_size=56, pretrain_img_size=28, patch_size=14, embed_dim=32,
           depth=2, num_heads=2, mlp_ratio=2.0, window_size=2,
           global_att_blocks=(1,), rope_style="sam3")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _img(seed, size=56):
    return np.random.default_rng(seed).normal(
        size=(1, size, size, 3)).astype(np.float32)


def test_vitdet_sam3_matches_skix():
    from skix.tracking.vitdet import ViTDetBackbone as SkixViTDet
    from skix_torch.tracking.vitdet import ViTDetBackbone

    r = np.random.default_rng(0)
    img = _img(1)
    m = SkixViTDet(**VIT)
    v = random_variables(m, r, jnp.asarray(img))
    assert v["params"]["pos_embed"].shape == (1, 2, 2, 32)
    want = jit0(m.apply)(v, jnp.asarray(img))
    port = ViTDetBackbone(**VIT)
    load_into(port, flax_to_state_dict(v))
    with torch.no_grad():
        got = port(torch.as_tensor(img))
    assert got.shape == (1, 4, 4, 32)
    _close(got, want)


def test_sam3_angles_and_rotation_equal_skix():
    """axial_rope_angles (x before y, theta 10000) are skix's, and the
    interleaved tables with the kernels' rotation equal the reference's
    pairwise rotation (apply_rope_interleaved)."""
    from skix.tracking.vitdet import apply_rope_interleaved as skix_apply
    from skix.tracking.vitdet import axial_rope_angles as skix_angles
    from skix_torch.ops.attention import apply_rope_tables
    from skix_torch.tracking.vitdet import (_sam3_rope_tables,
                                            apply_rope_interleaved,
                                            axial_rope_angles)

    ang = axial_rope_angles(3, 5, 16)
    np.testing.assert_array_equal(ang, skix_angles(3, 5, 16))
    x = np.random.default_rng(2).normal(size=(1, 2, 15, 16)).astype(
        np.float32)
    want = np.asarray(skix_apply(jnp.asarray(x), jnp.asarray(ang)))
    got = apply_rope_interleaved(torch.as_tensor(x), torch.as_tensor(ang))
    _close(got, want, 1e-6)
    cos, sin, rotate = _sam3_rope_tables(3, 5, 16, torch.device("cpu"))
    assert rotate == "interleaved"
    _close(apply_rope_tables(torch.as_tensor(x), cos, sin, rotate), want,
           1e-6)


@pytest.fixture(scope="module")
def detector_pair():
    """skix's and the port's tiny Sam3Detector in the sam3 configuration,
    one set of variables, a text prompt with a padded token; skix's
    outputs and its gradient of Σ scores + Σ boxes in one jitted call."""
    from skix.tracking.sam3_detector import Sam3Detector as SkixSam3
    from skix_torch.tracking.sam3_detector import Sam3Detector

    r = np.random.default_rng(5)
    img = r.random(size=(1, 112, 112, 3)).astype(np.float32)
    text = r.normal(size=(1, 4, 64)).astype(np.float32)
    pad = np.array([[False, False, False, True]])
    args = (img, text, pad)
    # one fusion and one decoder layer: the trunk is what the sam3
    # configuration changes
    kw = dict(rope_style="sam3", pretrain_img_size=56, encoder_layers=1,
              decoder_layers=1)
    m = SkixSam3.tiny(**kw)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), random_variables(
        m, r, *map(jnp.asarray, args)))

    def f(params):
        out = m.apply({"params": params}, *map(jnp.asarray, args))
        return jnp.sum(out.scores) + jnp.sum(out.boxes_cxcywh), out

    (_, want), grads = jit0(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    port = Sam3Detector.tiny(**kw)
    load_into(port, flax_to_state_dict(v))
    out = port(*map(torch.as_tensor, args))
    (out.scores.sum() + out.boxes_cxcywh.sum()).backward()
    got_grads = state_dict_to_flax(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in port.named_parameters()}, v)["params"]
    return out, want, got_grads, grads, port


@pytest.mark.parametrize("field", ["boxes_cxcywh", "scores", "mask_logits",
                                   "presence"])
def test_sam3_detector_tiny_sam3_matches_skix(detector_pair, field):
    got, want = detector_pair[:2]
    g, w = getattr(got, field).detach(), getattr(want, field)
    assert tuple(g.shape) == tuple(w.shape)
    _close(g, w)


def test_sam3_detector_tiny_sam3_gradient_matches_skix(detector_pair):
    """One gradient through the interleaved rope's backward (plain K5 at
    the windows, K3/K4 at the global block): d(Σ scores + Σ boxes)/dθ for
    every parameter, within 1e-4·max|g| + 1e-6 of each leaf."""
    _, _, got, want, port = detector_pair
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == sum(1 for _ in port.parameters())
    for path, w in flat_w:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max() + 1e-6,
                                   rtol=0, err_msg=str(path))
    qkv = np.asarray(want["backbone"]["block_0"]["attn"]["qkv"]["kernel"])
    assert np.abs(qkv).max() > 0      # the trunk's attention is reached


def _reference_vitdet_sd(r, C=32, depth=2, patch=14, grid=2, mlp=64):
    """A synthetic ViT-Det state dict in the reference's layout: pos_embed
    with its cls entry, no patch-embed bias."""
    n = lambda *s: (r.normal(size=s) * 0.05).astype(np.float32)  # noqa: E731
    sd = {"patch_embed.proj.weight": n(C, 3, patch, patch),
          "pos_embed": n(1, 1 + grid * grid, C),
          "ln_pre.weight": 1 + n(C), "ln_pre.bias": n(C)}
    for i in range(depth):
        pre = f"blocks.{i}."
        sd.update({pre + "norm1.weight": 1 + n(C), pre + "norm1.bias": n(C),
                   pre + "norm2.weight": 1 + n(C), pre + "norm2.bias": n(C),
                   pre + "attn.qkv.weight": n(3 * C, C),
                   pre + "attn.qkv.bias": n(3 * C),
                   pre + "attn.proj.weight": n(C, C),
                   pre + "attn.proj.bias": n(C),
                   pre + "mlp.fc1.weight": n(mlp, C),
                   pre + "mlp.fc1.bias": n(mlp),
                   pre + "mlp.fc2.weight": n(C, mlp),
                   pre + "mlp.fc2.bias": n(C)})
    return sd


def test_convert_vitdet_state_dict_matches_skix():
    from skix.tracking.vitdet import ViTDetBackbone as SkixViTDet
    from skix.tracking.vitdet import convert_vitdet_state_dict as skix_conv
    from skix_torch.tracking.vitdet import (ViTDetBackbone,
                                            convert_vitdet_state_dict)

    sd = _reference_vitdet_sd(np.random.default_rng(7))
    img = _img(8)
    want = jit0(SkixViTDet(**VIT).apply)(skix_conv(sd), jnp.asarray(img))
    converted = convert_vitdet_state_dict(sd)
    assert converted["pos_embed"].shape == (1, 2, 2, 32)
    np.testing.assert_array_equal(converted["patch_embed.proj.bias"], 0.0)
    port = ViTDetBackbone(**VIT)
    assert load_into(port, converted) == []
    with torch.no_grad():
        got = port(torch.as_tensor(img))
    _close(got, want)


def _reference_fusion_layer_sd(r, prefix="", d=64, ff=128):
    n = lambda *s: (r.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    sd = {}
    for name in ("norm1", "norm2", "norm3"):
        sd[f"{prefix}{name}.weight"] = 1 + n(d)
        sd[f"{prefix}{name}.bias"] = n(d)
    for name in ("self_attn", "cross_attn_image"):
        sd[f"{prefix}{name}.in_proj_weight"] = n(3 * d, d)
        sd[f"{prefix}{name}.in_proj_bias"] = n(3 * d)
        sd[f"{prefix}{name}.out_proj.weight"] = n(d, d)
        sd[f"{prefix}{name}.out_proj.bias"] = n(d)
    sd.update({f"{prefix}linear1.weight": n(ff, d),
               f"{prefix}linear1.bias": n(ff),
               f"{prefix}linear2.weight": n(d, ff),
               f"{prefix}linear2.bias": n(d)})
    return sd


def test_convert_fusion_encoder_matches_skix():
    """One layer through convert_fusion_encoder_layer, and a two-layer
    stack through convert_fusion_encoder, with a padded prompt."""
    from skix.tracking.sam3_detector import FusionEncoder as SkixEnc
    from skix.tracking.sam3_detector import \
        FusionEncoderLayer as SkixLayer
    from skix.tracking.sam3_detector import \
        convert_fusion_encoder as skix_conv
    from skix.tracking.sam3_detector import \
        convert_fusion_encoder_layer as skix_conv_layer
    from skix_torch.tracking.sam3_detector import (
        FusionEncoder, FusionEncoderLayer, convert_fusion_encoder,
        convert_fusion_encoder_layer)

    r = np.random.default_rng(9)
    src, pos = (r.normal(size=(1, 16, 64)).astype(np.float32)
                for _ in range(2))
    text = r.normal(size=(1, 4, 64)).astype(np.float32)
    pad = np.array([[False, False, True, True]])
    args = (src, pos, text, pad)
    sd = _reference_fusion_layer_sd(r)
    want = jit0(SkixLayer(dim_feedforward=128).apply)(
        {"params": skix_conv_layer(sd)}, *map(jnp.asarray, args))
    layer = FusionEncoderLayer(64, dim_feedforward=128)
    assert load_into(layer, convert_fusion_encoder_layer(sd)) == []
    with torch.no_grad():
        _close(layer(*map(torch.as_tensor, args)), want)

    sd = {**_reference_fusion_layer_sd(r, "layers.0."),
          **_reference_fusion_layer_sd(r, "layers.1.")}
    want = jit0(SkixEnc(num_layers=2, dim_feedforward=128).apply)(
        skix_conv(sd, num_layers=2), *map(jnp.asarray, args))
    enc = FusionEncoder(64, 2, dim_feedforward=128)
    assert load_into(enc, convert_fusion_encoder(sd, num_layers=2)) == []
    with torch.no_grad():
        _close(enc(*map(torch.as_tensor, args)), want)
