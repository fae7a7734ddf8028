"""skix_torch's SAM prompt encoder, mask decoder, interactive segmenter,
``SamImagePredictor`` and the VOS predictor's click and box prompts
against skix on the CPU, at small widths.

- ``SamPromptEncoder``: points (every label, ``-1`` pads), points and a
  box, a mask prompt, no prompt;
- ``SamMaskDecoder``: multimask on (with the high-resolution skips) and
  off, the dynamic fallback on each side of the 0.98 stability threshold;
  the selected mask index equal;
- both converters, fed synthetic state dicts in the reference's key names,
  against skix's conversion;
- ``InteractiveSegmenter`` through ``SamImagePredictor``: points, a box
  alone, a box with points;
- ``InteractiveVideoPredictor(segmenter=...)`` on the committed trained
  tracker (``tests/fixtures/tracker_tiny.npz``): skix's protocol sequences
  (``tests/test_vos_predictor.py``: a box as corner points, a correction
  click against the existing mask, relative coordinates, prompt-slot
  truncation, clearing, forward and reverse propagation, the errors).

The same weights (``_torch_parity.port_variables``) go to both packages.
Tolerances: float32 outputs to 1e-4 of their scale; selected indices and
object ids equal; masks on at least 99.9 % of pixels. skix's applies are
compiled at XLA's level 0 and shared by its predictors.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from _torch_parity import _CHEAP, cheap_jit, close_scaled, jit0, port_variables

from skix_torch.convert import flax_to_state_dict, state_dict_to_flax

FIXTURE = Path(__file__).parent / "fixtures" / "tracker_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
SEG = dict(features=16, img_size=64, num_heads=2)


def _masks_agree(got, want):
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.999


# --------------------------------------------------------------------------
# prompt encoder and decoder
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["points", "points_box", "mask", "none"])
def test_prompt_encoder_matches_skix(case):
    """Every case gives skix the tree with the mask convs; its ``apply``
    ignores them when no mask prompt is given."""
    from skix.tracking.sam_prompt_encoder import SamPromptEncoder as Skix
    from skix_torch.tracking.sam_prompt_encoder import SamPromptEncoder

    port = SamPromptEncoder(embed_dim=32, input_image_size=64).eval()
    v = port_variables(port, 1)
    m = Skix(embed_dim=32, input_image_size=64)
    r = np.random.default_rng(2)
    pts = r.uniform(0, 64, (2, 6, 2)).astype(np.float32)
    lab = np.array([[1, 0, 2, 3, -1, -1], [0, 1, -1, 1, 3, 2]], np.int32)
    box = np.array([[8, 8, 40, 48], [0, 2, 63, 60]], np.float32)
    mask = r.normal(size=(2, 32, 32, 1)).astype(np.float32)
    args = {"points": (pts, lab, None, None), "points_box": (pts, lab, box,
                                                             None),
            "mask": (None, None, None, mask),
            "none": (None, None, None, None)}[case]
    want = jit0(lambda v, *a: m.apply(v, (8, 8), *a))(v, *args)
    with torch.no_grad():
        got = port((8, 8), *(None if a is None else torch.as_tensor(a)
                             for a in args))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        close_scaled(g.detach().numpy(), np.asarray(w), 1e-4)


@pytest.fixture(scope="module")
def decoders():
    """skix's decoder, its level-0 applies (multimask with the
    high-resolution skips, single mask without), and the port's, with the
    same weights (the skip convs too)."""
    from skix.tracking.sam_decoder import SamMaskDecoder as Skix
    from skix_torch.tracking.sam_decoder import SamMaskDecoder

    kw = dict(transformer_dim=32, num_heads=2, mlp_dim=64, iou_hidden_dim=32)
    port = SamMaskDecoder(**kw, high_res=True).eval()
    v = port_variables(port, 4)
    m = Skix(**kw)
    applies = {mm: jit0(lambda v, e, pe, p, f4, f2, mm=mm:
                        m.apply(v, e, pe, p, mm, (f4, f2) if mm else None))
               for mm in (True, False)}
    return applies, v, port


def _selected(out):
    """The index of the returned mask among the four (they are copies)."""
    sel, masks = np.asarray(out.mask_logits), np.asarray(out.all_mask_logits)
    return [int(np.flatnonzero([np.array_equal(s, a) for a in ms])[0])
            for s, ms in zip(sel, masks)]


@pytest.mark.parametrize("case", ["multimask", "stable", "unstable"])
def test_mask_decoder_matches_skix(decoders, case):
    """``multimask``: the best IoU of tokens 1-3, with the high-resolution
    skips; single mask, ``stable``: token 0's mask pushed far above zero
    (stability 1, token 0 kept); ``unstable``: its hypernetwork zeroed
    (stability 0, the best multimask taken)."""
    applies, v, port = decoders
    r = np.random.default_rng(6)
    emb = r.normal(size=(2, 8, 8, 32)).astype(np.float32)
    pe = r.normal(size=(1, 8, 8, 32)).astype(np.float32)
    prompt = r.normal(size=(2, 3, 32)).astype(np.float32)
    f4 = r.normal(size=(2, 32, 32, 32)).astype(np.float32)
    f2 = r.normal(size=(2, 16, 16, 32)).astype(np.float32)
    mm = case == "multimask"
    sd = {k: t.clone() for k, t in port.state_dict().items()}
    if case == "stable":
        sd["upscale2.bias"] += 6.0
        sd["hyper_0.fc2.bias"] = torch.ones_like(sd["hyper_0.fc2.bias"])
    if case == "unstable":
        sd["hyper_0.fc2.weight"].zero_()
        sd["hyper_0.fc2.bias"].zero_()
    port.load_state_dict(sd)
    want = applies[mm](state_dict_to_flax(sd), emb, pe, prompt, f4, f2)
    with torch.no_grad():
        got = port(torch.as_tensor(emb), torch.as_tensor(pe),
                   torch.as_tensor(prompt), mm,
                   (torch.as_tensor(f4), torch.as_tensor(f2)) if mm
                   else None)
    for name in got._fields:
        close_scaled(getattr(got, name).numpy(),
                     np.asarray(getattr(want, name)), 1e-4)
    sel = _selected(want)
    assert _selected(got) == sel
    if case == "stable":
        assert sel == [0, 0]
    if case != "stable":
        assert 0 not in sel


def _reference_sd(names_shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) for k, s in names_shapes}


def test_converters_match_skix():
    """Synthetic state dicts in the reference's key names (the mask decoder
    with its high-resolution convs, the prompt encoder) → the port's
    converters against skix's conversion bridged to torch names; each
    loads into its module whole."""
    from skix.tracking.sam_decoder import convert_sam_mask_decoder as skix_dec
    from skix.tracking.sam_prompt_encoder import \
        convert_sam_prompt_encoder as skix_pe
    from skix_torch.tracking.sam_decoder import (SamMaskDecoder,
                                                 convert_sam_mask_decoder)
    from skix_torch.tracking.sam_prompt_encoder import (
        SamPromptEncoder, convert_sam_prompt_encoder)

    C, M, Hd = 32, 64, 24

    def lin(p, o, i):
        return [(f"{p}.weight", (o, i)), (f"{p}.bias", (o,))]

    def attn(p, ci):
        return (lin(f"{p}.q_proj", ci, C) + lin(f"{p}.k_proj", ci, C)
                + lin(f"{p}.v_proj", ci, C) + lin(f"{p}.out_proj", C, ci))

    def mlp3(p, dims):
        return sum((lin(f"{p}.layers.{i}", dims[i + 1], dims[i])
                    for i in range(3)), [])

    dec = [("obj_score_token.weight", (1, C)), ("iou_token.weight", (1, C)),
           ("mask_tokens.weight", (4, C)),
           ("transformer.norm_final_attn.weight", (C,)),
           ("transformer.norm_final_attn.bias", (C,)),
           ("output_upscaling.0.weight", (C, C // 4, 2, 2)),
           ("output_upscaling.0.bias", (C // 4,)),
           ("output_upscaling.1.weight", (C // 4,)),
           ("output_upscaling.1.bias", (C // 4,)),
           ("output_upscaling.3.weight", (C // 4, C // 8, 2, 2)),
           ("output_upscaling.3.bias", (C // 8,)),
           ("conv_s0.weight", (C // 8, C, 1, 1)), ("conv_s0.bias", (C // 8,)),
           ("conv_s1.weight", (C // 4, C, 1, 1)), ("conv_s1.bias", (C // 4,))]
    dec += attn("transformer.final_attn_token_to_image", C // 2)
    dec += mlp3("pred_obj_score_head", (C, C, C, 1))
    dec += mlp3("iou_prediction_head", (C, Hd, Hd, 4))
    for i in range(2):
        p = f"transformer.layers.{i}"
        dec += (attn(f"{p}.self_attn", C)
                + attn(f"{p}.cross_attn_token_to_image", C // 2)
                + attn(f"{p}.cross_attn_image_to_token", C // 2)
                + lin(f"{p}.mlp.lin1", M, C) + lin(f"{p}.mlp.lin2", C, M))
        for n in range(1, 5):
            dec += [(f"{p}.norm{n}.weight", (C,)), (f"{p}.norm{n}.bias", (C,))]
    for i in range(4):
        dec += mlp3(f"output_hypernetworks_mlps.{i}", (C, C, C, C // 8))
    pe = [("pe_layer.positional_encoding_gaussian_matrix", (2, C // 2)),
          ("not_a_point_embed.weight", (1, C)),
          ("no_mask_embed.weight", (1, C))]
    pe += [(f"point_embeddings.{i}.weight", (1, C)) for i in range(4)]
    for i, (o, ci, k) in {0: (4, 1, 2), 3: (16, 4, 2), 6: (C, 16, 1)}.items():
        pe += [(f"mask_downscaling.{i}.weight", (o, ci, k, k)),
               (f"mask_downscaling.{i}.bias", (o,))]
    pe += [(f"mask_downscaling.{i}.{leaf}", (n,)) for i, n in ((1, 4), (4, 16))
           for leaf in ("weight", "bias")]
    for names, skix_conv, port_conv, module in (
            (dec, skix_dec, convert_sam_mask_decoder,
             SamMaskDecoder(C, 2, mlp_dim=M, iou_hidden_dim=Hd,
                            high_res=True)),
            (pe, skix_pe, convert_sam_prompt_encoder,
             SamPromptEncoder(C, input_image_size=64))):
        sd = _reference_sd(names, len(names))
        want = flax_to_state_dict(skix_conv(sd))
        got = port_conv(sd)
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0,
                                       msg=k)
        module.load_state_dict(got)


# --------------------------------------------------------------------------
# the segmenter, the image predictor, the video predictor
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def segmenters():
    """skix's segmenter and variables, the port's with the same weights,
    and one level-0 decode shared by skix's predictors (``_seg_predict``
    and the image predictor's decodes), with ``apply_model`` at level 0."""
    import skix.tracking.vos_predictor as VP
    import skix.utils.jitapply as JA
    from skix.tracking.sam_prompt_encoder import InteractiveSegmenter as Skix
    from skix_torch.tracking.sam_prompt_encoder import InteractiveSegmenter

    port = InteractiveSegmenter(**SEG).eval()
    v = port_variables(port, 8)
    m = Skix(**SEG)
    decode = cheap_jit(jax.jit(
        lambda seg, v, f, p, l, b, mi, mm: seg.apply(
            v, f, p, l, b, mi, mm, method=seg.predict_from_embedding),
        static_argnums=(0, 7)), (0, 7))
    mp = pytest.MonkeyPatch()
    cheap = jax.jit(JA.apply_model.__wrapped__, static_argnums=(0, 1),
                    compiler_options=_CHEAP)
    mp.setattr(JA, "apply_model", cheap)
    mp.setattr(VP, "apply_model", cheap)
    mp.setattr(VP, "_seg_predict", lambda seg, v, f, p, l, mi:
               decode(seg, v, f, p, l, None, mi, True))
    yield m, v, port, decode, cheap
    mp.undo()


def test_image_predictor_matches_skix(segmenters):
    """set_image once (a 48 × 96 uint8 frame), then points, a box alone and
    a box with points; the errors."""
    from skix.tracking.sam_prompt_encoder import SamImagePredictor as Skix
    from skix_torch.tracking.sam_prompt_encoder import SamImagePredictor

    m, v, port, decode, cheap = segmenters
    sp, pp = Skix(m, v), SamImagePredictor(port)
    sp._encode = lambda v, x: cheap(m, "encode_image", v, x)
    sp._decode = lambda v, f, p, l, mm: decode(m, v, f, p, l, None, None, mm)
    sp._decode_box = lambda v, f, p, l, b, mm: decode(m, v, f, p, l, b, None,
                                                      mm)
    for p in (sp, pp):
        with pytest.raises(RuntimeError, match="set_image"):
            p.predict([[10, 10]], [1])
    image = np.random.default_rng(9).integers(0, 255, (48, 96, 3)
                                              ).astype(np.uint8)
    sp.set_image(image)
    pp.set_image(image)
    close_scaled(pp.get_image_embedding().numpy(),
                 np.asarray(sp.get_image_embedding()), 1e-4)
    for args in (([[30, 20], [80, 40]], [1, 0]),
                 (None, None, [10, 5, 60, 40]),
                 ([[30, 20]], [1], [10, 5, 60, 40])):
        want, got = sp.predict(*args), pp.predict(*args)
        _masks_agree(got[0], np.asarray(want[0]))
        close_scaled(got[1], np.asarray(want[1]), 1e-4)
        close_scaled(got[2], np.asarray(want[2]), 1e-4)
    for p in (sp, pp):
        with pytest.raises(ValueError, match="at most 8 points"):
            p.predict([[1, 1]] * 9, [1] * 9)
        p.reset_predictor()
        with pytest.raises(RuntimeError):
            p.get_image_embedding()


def _same_outputs(got, want):
    assert [o["frame_index"] for o in got] == [o["frame_index"] for o in want]
    for g, w in zip(got, want):
        assert g["obj_ids"] == w["obj_ids"]
        close_scaled(g["logits"], w["logits"], 1e-4)
        _masks_agree(g["masks"], w["masks"])


def test_video_predictor_prompts_match_skix(segmenters, caplog):
    """skix's protocol sequences with both packages' predictors on the
    fixture tracker: a box on frame 0 (corner labels 2/3 ahead), a
    correction click against that mask, relative coordinates, nine clicks
    into eight slots (the head kept), a mask then a click on frame 2,
    forward and reverse propagation, clearing, and the errors."""
    import make_tracker_fixture as mtf
    from skix.tracking.memory_tracker import MaskMemoryTracker as SkixTrk
    from skix.tracking.vos_predictor import InteractiveVideoPredictor as Skix
    from skix_torch.tracking.fixture import TRACKER, load_tracker_fixture
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor

    m, v, port, _, _ = segmenters
    _, trk_vars = mtf.load_fixture(FIXTURE)
    _, trk = load_tracker_fixture(FIXTURE, device="cpu")
    frames, _, masks, _ = mtf.synth_clip(20_003, T=5, n_obj=2, min_sep=1.5)
    u8 = (frames * 255).astype(np.uint8)
    sp = Skix(SkixTrk(**TRACKER), trk_vars, m, v)
    pp = InteractiveVideoPredictor(trk, port)
    ss, ps = sp.init_state(u8), pp.init_state(u8)
    calls = [
        lambda p, s: p.add_new_points_or_box(s, 0, 1, box=[20, 24, 70, 80]),
        lambda p, s: p.add_new_points_or_box(s, 0, 1, points=[[40.0, 50.0]],
                                             labels=[1],
                                             clear_old_points=False),
        lambda p, s: p.add_new_points_or_box(s, 0, 2, points=[[0.5, 0.25]],
                                             labels=[1],
                                             rel_coordinates=True),
        lambda p, s: p.add_new_points_or_box(
            s, 1, 2, points=[[10.0 * k, 12.0] for k in range(8)],
            labels=[1] * 8, box=[5, 5, 90, 90]),
        lambda p, s: p.add_new_mask(s, 2, 3, masks[2, 0]),
        lambda p, s: p.add_new_points_or_box(s, 2, 3, points=[[30.0, 30.0]],
                                             labels=[0],
                                             clear_old_points=False)]
    for call in calls:
        want, got = call(sp, ss), call(pp, ps)
        close_scaled(got.numpy(), np.asarray(want), 1e-4)
    assert any("prompt slots full" in r.getMessage() for r in caplog.records)
    for obj, f, labels in ((1, 0, [2, 3, 1]), (2, 0, [1]),
                           (2, 1, [2, 3] + [1] * 8), (3, 2, [0])):
        pts, lab = ps["objects"][obj]["points"][f]
        want_pts, want_lab = ss["objects"][obj]["points"][f]
        assert lab.tolist() == want_lab.tolist() == labels
        np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_allclose(ps["objects"][2]["points"][0][0][0], [56, 28])
    assert sorted(ps["seg_feats"]) == sorted(ss["seg_feats"]) == [0, 1, 2]
    _same_outputs(list(pp.propagate_in_video(ps)),
                  list(sp.propagate_in_video(ss)))
    _same_outputs(list(pp.propagate_in_video(ps, reverse=True,
                                             max_frame_num_to_track=2)),
                  list(sp.propagate_in_video(ss, reverse=True,
                                             max_frame_num_to_track=2)))
    for p, s in ((pp, ps), (sp, ss)):
        p.clear_all_points_in_frame(s, 2, 3)
        assert set(s["objects"][3]["cond"]) == set()
        p.clear_all_points_in_video(s)
        assert set(s["objects"][1]["cond"]) == set()
        with pytest.raises(ValueError, match="clearing old points"):
            p.add_new_points_or_box(s, 0, 1, box=[1, 1, 9, 9],
                                    clear_old_points=False)
        with pytest.raises(ValueError, match="together"):
            p.add_new_points_or_box(s, 0, 1, points=[[1.0, 1.0]])
        with pytest.raises(ValueError, match="at least one"):
            p.add_new_points_or_box(s, 0, 1)
