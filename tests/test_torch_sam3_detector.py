"""skix_torch.tracking.{vitdet,sam3_detector} against skix at tiny widths.

The same random flax variables (``_torch_parity.random_variables``) go
through ``skix_torch.convert`` into the port; both packages run the same
numpy inputs on the CPU in float32. skix's attention there is its XLA
reference (natural-log softmax), the port's the plain versions of K1/K2
(base-2 softmax with the kernels' roundings): the outputs agree to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import jit0, random_variables

from skix_torch.convert import flax_to_state_dict, load_into

ATOL = 1e-4
TINY_VIT = dict(img_size=112, patch_size=14, embed_dim=64, depth=2,
                num_heads=2, mlp_ratio=4.0, window_size=4,
                global_att_blocks=(1,))


def _port(module, variables):
    load_into(module, flax_to_state_dict(variables))
    return module.eval()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def prompt():
    r = np.random.default_rng(3)
    text = r.normal(size=(1, 4, 64)).astype(np.float32)
    pad = np.array([[False, False, False, True]])
    return text, pad


def test_vitdet_backbone_matches_skix():
    """Window blocks (K2's plain version, window-local rope tables) and the
    global block (K1's, global-grid tables)."""
    from skix.tracking.vitdet import ViTDetBackbone as SkixViTDet
    from skix_torch.tracking.vitdet import ViTDetBackbone

    r = np.random.default_rng(0)
    img = r.normal(size=(1, 112, 112, 3)).astype(np.float32)
    m = SkixViTDet(**TINY_VIT)
    v = random_variables(m, r, jnp.asarray(img))
    want = jit0(m.apply)(v, jnp.asarray(img))
    with torch.no_grad():
        got = _port(ViTDetBackbone(**TINY_VIT), v)(_t(img))
    assert got.shape == (1, 8, 8, 64)
    _close(got, want)


def test_vitdet_remat_gives_the_same_gradients():
    """``remat=True`` (each block under torch.utils.checkpoint, skix's
    nn.remat) recomputes the blocks in the backward: the same output and
    the same parameter and input gradients as without it."""
    from skix_torch.tracking.vitdet import ViTDetBackbone

    gen = torch.Generator().manual_seed(0)
    plain = ViTDetBackbone(**TINY_VIT)
    with torch.no_grad():
        for p in plain.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    remat = ViTDetBackbone(**TINY_VIT, remat=True)
    remat.load_state_dict(plain.state_dict())
    img = torch.randn((1, 112, 112, 3), generator=gen)
    got = []
    for m in (plain, remat):
        x = img.clone().requires_grad_()
        out = m(x)
        out.backward(torch.ones_like(out))
        got.append((out.detach(), x.grad,
                    {n: p.grad for n, p in m.named_parameters()}))
    (o1, gx1, g1), (o2, gx2, g2) = got
    torch.testing.assert_close(o2, o1, atol=0, rtol=0)
    torch.testing.assert_close(gx2, gx1, atol=1e-6, rtol=0)
    for n in g1:
        torch.testing.assert_close(g2[n], g1[n], atol=1e-6, rtol=1e-5,
                                   msg=n)


def test_vitdet_refuses_what_is_not_ported():
    from skix_torch.tracking.vitdet import ViTDetBackbone

    # rope_style "sam3" is ported (tests/test_torch_vitdet_sam3.py); a
    # style skix does not have is refused
    with pytest.raises(ValueError, match="rope_style"):
        ViTDetBackbone(**TINY_VIT, rope_style="axial")
    with pytest.raises(NotImplementedError, match="window_flash"):
        ViTDetBackbone(**TINY_VIT, window_flash=False)


def test_simple_fpn_neck_matches_skix():
    """ConvTranspose (flax's unflipped kernel), max pool, 1×1 and SAME 3×3
    convs, and the sine position maps."""
    from skix.tracking.vitdet import SimpleFPNNeck as SkixNeck
    from skix_torch.tracking.vitdet import SimpleFPNNeck

    r = np.random.default_rng(1)
    feat = r.normal(size=(2, 8, 6, 64)).astype(np.float32)
    m = SkixNeck(d_model=32)
    v = random_variables(m, r, jnp.asarray(feat))
    want_f, want_p = jit0(m.apply)(v, jnp.asarray(feat))
    with torch.no_grad():
        got_f, got_p = _port(SimpleFPNNeck(64, 32), v)(_t(feat))
    assert [tuple(x.shape) for x in got_f] == [(2, 32, 24, 32), (2, 16, 12, 32),
                                              (2, 8, 6, 32), (2, 4, 3, 32)]
    for g, w in zip(got_f + got_p, list(want_f) + list(want_p)):
        _close(g, w)


@pytest.mark.parametrize("flash_min_seq", [2048, 16])
def test_fusion_encoder_matches_skix(prompt, flash_min_seq):
    """Image self-attention plain (L < 2048, the tiny default) and through
    the flash entry (the full-size route, K1's plain version here)."""
    from skix.tracking.sam3_detector import FusionEncoder as SkixEnc
    from skix_torch.tracking.sam3_detector import FusionEncoder

    text, pad = prompt
    r = np.random.default_rng(2)
    src = r.normal(size=(1, 64, 64)).astype(np.float32)
    pos = r.normal(size=(1, 64, 64)).astype(np.float32)
    m = SkixEnc(num_layers=2, self_flash_min_seq=flash_min_seq)
    args = (src, pos, text, pad)
    v = random_variables(m, r, *map(jnp.asarray, args))
    want = jit0(m.apply)(v, *map(jnp.asarray, args))
    with torch.no_grad():
        got = _port(FusionEncoder(64, 2, self_flash_min_seq=flash_min_seq),
                    v)(*map(_t, args))
    _close(got, want)


def test_query_decoder_matches_skix(prompt):
    """Box refinement with boxRPB bias and the presence token."""
    from skix.tracking.sam3_detector import QueryDecoder as SkixDec
    from skix_torch.tracking.sam3_detector import QueryDecoder

    text, pad = prompt
    r = np.random.default_rng(4)
    mem = r.normal(size=(1, 64, 64)).astype(np.float32)
    pos = r.normal(size=(1, 64, 64)).astype(np.float32)
    m = SkixDec(num_queries=12, num_layers=2, box_rpb="log")
    args = (mem, pos, text, pad)
    v = random_variables(m, r, *map(jnp.asarray, args), feat_hw=(8, 8))
    want = jit0(lambda v, *a: m.apply(v, *a, feat_hw=(8, 8)))(
        v, *map(jnp.asarray, args))
    with torch.no_grad():
        got = _port(QueryDecoder(64, 12, 2, box_rpb="log"), v)(
            *map(_t, args), feat_hw=(8, 8))
    for name in ("queries", "boxes", "presence"):
        _close(getattr(got, name), getattr(want, name))
    for g, w in zip(got.all_boxes, want.all_boxes):
        _close(g, w)


@pytest.fixture(scope="module")
def detector_pair(prompt):
    from skix.tracking.sam3_detector import Sam3Detector as SkixSam3
    from skix_torch.tracking.sam3_detector import Sam3Detector

    text, pad = prompt
    r = np.random.default_rng(5)
    img = r.random(size=(1, 112, 112, 3)).astype(np.float32)
    m = SkixSam3.tiny()
    v = random_variables(m, r, jnp.asarray(img), jnp.asarray(text),
                         jnp.asarray(pad))
    want = jit0(m.apply)(v, jnp.asarray(img), jnp.asarray(text),
                            jnp.asarray(pad))
    port = _port(Sam3Detector.tiny(), v)
    with torch.no_grad():
        got = port(_t(img), _t(text), _t(pad))
    return got, want, port


@pytest.mark.parametrize("field", ["boxes_cxcywh", "scores", "mask_logits",
                                   "embeddings", "presence"])
def test_sam3_detector_tiny_matches_skix(detector_pair, field):
    got, want, _ = detector_pair
    g, w = getattr(got, field), getattr(want, field)
    assert tuple(g.shape) == tuple(w.shape)
    _close(g, w)


def test_sam3_detector_random_init_is_finite():
    """Seeded random weights on a meta-built model (the stage's smoke mode)
    touch every parameter."""
    from skix_torch.tracking.sam3_detector import Sam3Detector

    with torch.device("meta"):
        m = Sam3Detector.tiny()
    m = m.to_empty(device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    for name, p in m.named_parameters():
        assert torch.isfinite(p).all(), name
    assert float(m.decoder.init_boxes.detach().std()) > 0.1


def test_sam3_detector_refuses_training_and_geometry(detector_pair):
    """A detector built without the geometry encoder (skix's tree had no
    such branch) refuses point and box prompts, in training mode too, with
    a ValueError naming the flag; the geometric prompts themselves are
    checked in tests/test_torch_geometry_prompts.py. The training outputs
    (DAC, aux scores) are checked in tests/test_torch_train_detector.py;
    without a text prompt a detector built without the null_prompt token
    refuses the call."""
    _, _, port = detector_pair
    img, text = torch.zeros(1, 112, 112, 3), torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="geometry=True"):
        port(img, text, apply_dac=True, points=torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="geometry=True"):
        port(img, text, boxes=torch.zeros(1, 4, 4))
    with pytest.raises(ValueError, match="null_prompt"):
        port(img)
