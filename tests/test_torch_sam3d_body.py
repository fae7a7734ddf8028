"""skix_torch's SAM-3D-Body modules against skix's, on the CPU at a tiny width.

Each flax module gets random variables (``_torch_parity``), which
``skix_torch.convert`` turns into the torch module's ``state_dict``; both
see the same numpy inputs. The crop is held to ``jax.image.
scale_and_translate`` at 1e-5; the modules and the model (three backbones,
the hand decoder, ``hand_override``, the mask gate, prompts) at 1e-4,
relative to the largest element where that exceeds 1 (crop pixels, cm-scale
rig sums). skix's applies are jitted once per call signature.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import (assert_sam3d_outputs_close, jit0, random_variables,
                           sam3d_body_pair)

from skix.models import sam3d_body as S
from skix_torch.convert import flax_to_state_dict, load_into
from skix_torch.models import sam3d_body as P

rng = np.random.default_rng(3131)
CROP, EMBED, HEADS = 32, 32, 2


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _port(module, variables):
    extra = load_into(module, flax_to_state_dict(variables))
    assert not extra, extra
    return module.eval()


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
def test_mask_downscaler_and_its_converter():
    """The mask encoder on skix's variables, and the torch ``Sequential``
    layout through ``convert_mask_downscaling``: the same tree as skix's,
    the same output."""
    m = rng.random((2, 32, 32, 1)).astype(np.float32) > 0.5
    m = m.astype(np.float32)
    smod = S.MaskDownscaler(EMBED)
    v = random_variables(smod, rng, jnp.asarray(m))
    want = jit0(smod.apply)(v, jnp.asarray(m))
    got = _port(P.MaskDownscaler(EMBED), v)(_t(m))
    assert got.shape == (2, 2, 2, EMBED)
    _close(got.detach(), want)
    sd = {"mask_downscaling.0.weight": rng.normal(size=(4, 1, 4, 4)),
          "mask_downscaling.0.bias": rng.normal(size=4),
          "mask_downscaling.1.weight": rng.normal(size=4),
          "mask_downscaling.1.bias": rng.normal(size=4),
          "mask_downscaling.3.weight": rng.normal(size=(16, 4, 4, 4)),
          "mask_downscaling.3.bias": rng.normal(size=16),
          "mask_downscaling.4.weight": rng.normal(size=16),
          "mask_downscaling.4.bias": rng.normal(size=16),
          "mask_downscaling.6.weight": rng.normal(size=(EMBED, 16, 1, 1)),
          "mask_downscaling.6.bias": rng.normal(size=EMBED)}
    sd = {k: np.asarray(x, np.float32) for k, x in sd.items()}
    a, b = S.convert_mask_downscaling(sd), P.convert_mask_downscaling(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    want = jit0(smod.apply)({"params": a}, jnp.asarray(m))
    _close(_port(P.MaskDownscaler(EMBED), {"params": b})(_t(m)).detach(),
           want)


def test_cross_attn_block_and_prompt_encoder():
    q = rng.normal(size=(2, 2, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 7, 64)).astype(np.float32)
    smod = S.CrossAttnBlock(8)
    v = random_variables(smod, rng, jnp.asarray(q), jnp.asarray(kv))
    with torch.no_grad():
        _close(_port(P.CrossAttnBlock(64, 8), v)(_t(q), _t(kv)),
               jit0(smod.apply)(v, q, kv))
    prompts = np.concatenate([rng.random((2, 5, 2)),
                              rng.integers(0, 2, (2, 5, 1))], -1)
    prompts = prompts.astype(np.float32)
    valid = rng.random((2, 5)) > 0.3
    smod = S.PromptEncoder(64)
    v = random_variables(smod, rng, jnp.asarray(prompts), jnp.asarray(valid))
    want, _ = jit0(smod.apply)(v, prompts, valid)
    with torch.no_grad():
        got, _ = _port(P.PromptEncoder(64), v)(_t(prompts),
                                               torch.tensor(valid))
    _close(got, want)


# --------------------------------------------------------------------------
# the model, with each backbone
# --------------------------------------------------------------------------
_MODELS = {}


def _model(backbone):
    if backbone not in _MODELS:
        _MODELS[backbone] = sam3d_body_pair(
            rng, crop_size=CROP, embed_dim=EMBED, depth=1, num_heads=HEADS,
            decoder_depth=1, backbone=backbone)
    return _MODELS[backbone]


@pytest.mark.parametrize("call", ["body", "hand", "hand_override"])
def test_sam3d_body_calls(call):
    """The vit_hmr model (the DINO-family backbones:
    ``test_torch_dinov3.py``): the body pass with a crop-aligned mask whose
    scores are 0 for one row (no_mask_embed) and 0.7 for the other (the
    scaled embedding), and keypoint prompts; the hand decoder; the body
    pass with ``hand_override``. Every output field, the MHR head's too."""
    smod, v, model, apply = _model("vit_hmr")
    crops = rng.random((2, CROP, CROP, 3)).astype(np.float32)
    if call == "body":
        kw = {"mask": (rng.random((2, CROP, CROP, 1)) > 0.5).astype(
                  np.float32),
              "mask_score": np.array([0.0, 0.7], np.float32),
              "prompts": np.concatenate(
                  [rng.random((2, 3, 2)), np.ones((2, 3, 1))], -1).astype(
                      np.float32),
              "prompt_valid": np.array([[1, 1, 0], [1, 0, 0]], bool)}
    elif call == "hand":
        kw = {"decoder_type": "hand"}
    else:
        kw = {"hand_override": (rng.normal(size=(2, 108)) * 0.3
                                ).astype(np.float32)}
    want = apply(v, crops, **kw)
    tkw = {k: (torch.tensor(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}
    with torch.no_grad():
        got = model(_t(crops), **tkw)
    assert_sam3d_outputs_close(got, want)


def test_mask_defaults():
    """A given mask defaults to score 1; no mask is a zero mask at score 0
    (skix runs the mask encoder on zeros, the port skips it)."""
    _, _, model, _ = _model("vit_hmr")
    crops = _t(rng.random((2, CROP, CROP, 3)))
    mask = _t(rng.random((2, CROP, CROP, 1)) > 0.5)
    with torch.no_grad():
        a = model(crops, mask=mask)
        b = model(crops, mask=mask, mask_score=torch.ones(2))
        c = model(crops)
        d = model(crops, mask=torch.zeros_like(mask),
                  mask_score=torch.zeros(2))
    torch.testing.assert_close(a.joints_3d, b.joints_3d, rtol=0, atol=0)
    torch.testing.assert_close(c.joints_3d, d.joints_3d, rtol=0, atol=0)
    assert not torch.equal(a.joints_3d, c.joints_3d)


def test_named_dinov3_variant_takes_published_depth_and_heads():
    m = P.SAM3DBody(embed_dim=384, backbone="dinov3_vits16plus",
                    crop_size=32, decoder_depth=1)
    assert m.dino_backbone.depth == 12
    assert m.dino_backbone.block_0.attn.num_heads == 6
    assert m.dino_backbone.block_0.ffn == "swiglu"
    with pytest.raises(ValueError, match="1280-dim"):
        P.SAM3DBody(embed_dim=384, backbone="dinov3_vith16plus")
    with pytest.raises(ValueError, match="unknown dinov3 variant"):
        P.SAM3DBody(backbone="dinov3_nope")
