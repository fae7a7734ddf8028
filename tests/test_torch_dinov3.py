"""skix_torch's DINOv3 trunk (and SAM3DBody's two DINO-family backbones)
against skix's, on the CPU at a tiny width.

The rope periods and coordinates must be skix's exactly; the trunk and the
model 1e-4 (relative to the largest element where that exceeds 1). The hub
converter runs on a synthesized state dict of skix's reference layout
(``dinov3_reference_state_dict_spec``), as ``tests/test_dinov3.py`` does:
its tree must be skix's, and load into the port's trunk with no leaf
missing or left over.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import (assert_sam3d_outputs_close, close_scaled, jit0,
                           random_variables, sam3d_body_pair)

from skix.models import dinov3 as S
from skix_torch.convert import flax_to_state_dict, load_into
from skix_torch.models import dinov3 as P

rng = np.random.default_rng(1616)
KW = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2,
          n_storage_tokens=4)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("kw", [dict(head_dim=16), dict(head_dim=64),
                                dict(head_dim=32, min_period=0.5,
                                     max_period=90.0)])
def test_rope_periods_exact(kw):
    hd = kw.pop("head_dim")
    np.testing.assert_array_equal(P.dinov3_rope_periods(hd, **kw),
                                  S.dinov3_rope_periods(hd, **kw))


@pytest.mark.parametrize("mode", ["separate", "min", "max"])
def test_rope_coords_exact(mode):
    for a, b in zip(P.dinov3_rope_coords(3, 5, mode),
                    S.dinov3_rope_coords(3, 5, mode)):
        np.testing.assert_array_equal(a, b)


def test_tables_have_identity_prefix_rows():
    """The port's full-sequence tables: cos 1 and sin 0 on the 5 prefix
    rows (the rope pass leaves them as they are), skix's angles on the
    patch rows, and a sin table symmetric under the one-segment
    rotate-half (the exact-backward condition)."""
    periods = S.dinov3_rope_periods(16)
    cos, sin = P.rope_tables_with_prefix(_t(periods), 3, 4, 5)
    assert cos.shape == sin.shape == (5 + 12, 16)
    assert torch.equal(cos[:5], torch.ones(5, 16))
    assert torch.equal(sin[:5], torch.zeros(5, 16))
    want_c, want_s = S.dinov3_rope_tables(3, 4, periods)
    close_scaled(cos[5:], want_c, 1e-6)
    close_scaled(sin[5:], want_s, 1e-6)
    torch.testing.assert_close(sin[:, :8], sin[:, 8:], rtol=0, atol=0)


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_trunk_matches_skix(ffn):
    x = rng.normal(size=(2, 32, 24, 3)).astype(np.float32)
    smod = S.Dinov3Trunk(ffn=ffn, **KW)
    v = random_variables(smod, rng, jnp.asarray(x))
    v = {"params": dict(v["params"], rope_periods=S.dinov3_rope_periods(16))}
    want = jit0(smod.apply)(v, x)
    trunk = P.Dinov3Trunk(ffn=ffn, **KW)
    assert not load_into(trunk, flax_to_state_dict(v))
    with torch.no_grad():
        got = trunk.eval()(_t(x))
    assert got.shape == (2, 12, 32)
    close_scaled(got, want, 1e-4)


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_hub_converter_matches_skix_and_loads(ffn):
    spec = S.dinov3_reference_state_dict_spec(ffn=ffn, **{
        k: v for k, v in KW.items()})
    sd = {f"encoder.{k}": rng.normal(size=s).astype(np.float32)
          for k, s in spec.items()}
    want = S.convert_dinov3_trunk(sd, ffn=ffn)
    got = P.convert_dinov3_trunk(sd, ffn=ffn)
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(got))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), want,
        got)
    assert P.infer_dinov3_config(sd) == S.infer_dinov3_config(sd)
    trunk = P.Dinov3Trunk(ffn=ffn, **KW)
    assert not load_into(trunk, flax_to_state_dict(got))
    np.testing.assert_array_equal(trunk.rope_periods.numpy(),
                                  sd["encoder.rope_embed.periods"])


def test_hub_converter_without_periods_needs_head_dim():
    spec = S.dinov3_reference_state_dict_spec(**KW)
    spec.pop("rope_embed.periods")
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in spec.items()}
    with pytest.raises(ValueError, match="head_dim"):
        P.convert_dinov3_trunk(sd)
    np.testing.assert_array_equal(
        P.convert_dinov3_trunk(sd, head_dim=16)["params"]["rope_periods"],
        S.dinov3_rope_periods(16))


def test_variants_are_skix_table():
    assert P.DINOV3_VARIANTS == S.DINOV3_VARIANTS


@pytest.mark.parametrize("backbone", ["dino", "dinov3"])
def test_sam3d_body_dino_backbones(backbone):
    """SAM3DBody's body pass over each DINO-family backbone (the
    DINOv2-shaped ViT with registers, the DINOv3 trunk), with a mask whose
    scores are 0 and 0.7: every output field."""
    smod, v, model, apply = sam3d_body_pair(
        rng, crop_size=32, embed_dim=32, depth=1, num_heads=2,
        decoder_depth=1, backbone=backbone)
    crops = rng.random((2, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    score = np.array([0.0, 0.7], np.float32)
    want = apply(v, crops, mask=mask, mask_score=score)
    with torch.no_grad():
        got = model(_t(crops), mask=_t(mask), mask_score=_t(score))
    assert_sam3d_outputs_close(got, want)
