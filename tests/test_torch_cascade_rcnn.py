"""skix_torch's cascade Mask R-CNN human detector against skix's, on the CPU:
the decomposed rel-pos bias, the raw heads before the box stages' NMS, the
detections, the post-processing and the detectron2 converter. The
detector's pre- and post-processing around the network, its person slots
and the side stage with it in the loop are
``tests/test_torch_side_detector.py``.

The cascade is the tiny trunk of skix's own tests
(``tests/test_cascade_rcnn.py``: embed 32, depth 2, heads 2, window 2, one
global block, 64 px) under the heads the side stage builds (80 classes,
256 / 128 proposal slots, 16 detections), seeded and handed to skix as
flax variables (the person logits lifted so that boxes pass the
thresholds); skix's forward and raw heads of one image are one program,
compiled once.
Tolerances: 1e-4 in float32, relative to an array's largest element where
that exceeds 1 (boxes in pixels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import close_scaled, compile_once, port_variables

from skix.models import cascade_rcnn as S
from skix_torch.models import cascade_rcnn as P

KW = dict(embed_dim=32, depth=2, num_heads=2, window_size=2,
          global_indexes=(1,))
SIZE = 64
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _skix_raw(m, images):
    """skix's heads before the per-class NMS, through its own submodules:
    per image the RPN outputs, the proposal slots and each cascade stage's
    logits and deltas."""
    from skix.models.keypoint_rcnn import (ANCHOR_SIZES, apply_deltas,
                                           multilevel_roi_align)

    B, H, W, _ = images.shape
    feats = m.fpn(m.net((images - jnp.asarray(_MEAN)) / jnp.asarray(_STD)))
    rpn = m.rpn(feats)
    shapes = [(f.shape[1], f.shape[2], st, sz)
              for f, st, sz in zip(feats, (4, 8, 16, 32, 64), ANCHOR_SIZES)]
    out = []
    for b in range(B):
        boxes = m.propose([(o[b], d[b]) for o, d in rpn], shapes, (H, W))
        props, stages = boxes, []
        for k in range(3):
            rois = multilevel_roi_align([f[b] for f in feats], boxes, 7)
            s, d = m.box_heads[k](rois)
            stages.append((s, d))
            boxes = m._clip(apply_deltas(boxes, d,
                                         S.CASCADE_STAGE_WEIGHTS[k]), H, W)
        out.append(([o[b].reshape(-1) for o, _ in rpn],
                    [d[b].reshape(-1, 4) for _, d in rpn], props, stages,
                    boxes))
    return out


@pytest.fixture(scope="module")
def pair():
    """The port's model with seeded weights (the person logits lifted so
    that boxes pass the thresholds), and skix's detections and raw heads
    of one image on the same values, one compiled program."""
    with torch.device("meta"):
        model = P.CascadeMaskRCNN(**KW, image_size=SIZE)
    model = model.to_empty(device="cpu").eval()
    variables = port_variables(model, 11)
    for k in range(3):
        variables["params"][f"box_head{k}"]["cls_score"]["bias"][0] += 4.5
        with torch.no_grad():
            getattr(model, f"box_head{k}").cls_score.bias[0] += 4.5
    smod = S.CascadeMaskRCNN(**KW)
    x = np.random.default_rng(2).random((1, SIZE, SIZE, 3)).astype(
        np.float32)
    want, want_raw = compile_once(lambda v, im: smod.apply(
        v, im, method=lambda m, y: (m(y), _skix_raw(m, y))), variables,
        jnp.asarray(x))(variables, jnp.asarray(x))
    return model, x, want, want_raw


def test_decomposed_rel_pos_bias_matches_skix():
    """The bias alone, with unequal q/k sizes (short-side scaling) and a
    table that must be resized (jax's linear resize)."""
    rng = np.random.default_rng(1)
    assert np.array_equal(P.rel_pos_index(3, 7), S.rel_pos_index(3, 7))
    for (qh, qw), (kh, kw), L in (((3, 3), (3, 3), 5), ((2, 5), (4, 3), 7)):
        q = rng.standard_normal((2, qh * qw, 4)).astype(np.float32)
        attn = rng.standard_normal((2, qh * qw, kh * kw)).astype(np.float32)
        rh, rw = (rng.standard_normal((L, 4)).astype(np.float32)
                  for _ in range(2))
        want = S.add_decomposed_rel_pos(*(jnp.asarray(a) for a in
                                          (attn, q, rh, rw)),
                                        (qh, qw), (kh, kw))
        got = P.add_decomposed_rel_pos(*(torch.as_tensor(a) for a in
                                         (attn, q, rh, rw)),
                                       (qh, qw), (kh, kw))
        close_scaled(got.numpy(), np.asarray(want), 1e-5)


def test_raw_heads_match_skix(pair):
    """The RPN heads, the proposal slots, and every cascade stage's logits
    and deltas before the per-class NMS."""
    model, x, _, want = pair
    got = model.raw_heads(torch.as_tensor(x))
    for g, (logits, deltas, props, stages, boxes) in zip(got, want):
        for a, b in zip(g.rpn_logits + g.rpn_deltas, logits + deltas):
            close_scaled(a.numpy(), np.asarray(b), 1e-4)
        close_scaled(g.proposals.numpy(), np.asarray(props), 1e-4)
        for k, (s, d) in enumerate(stages):
            close_scaled(g.stage_logits[k].numpy(), np.asarray(s), 1e-4)
            close_scaled(g.stage_deltas[k].numpy(), np.asarray(d), 1e-4)
        close_scaled(g.boxes.numpy(), np.asarray(boxes), 1e-4)


def test_detections_match_skix(pair):
    """The detection slots after the per-class NMS: classes and validity
    equal (some valid), boxes, scores and masks within 1e-4."""
    model, x, want, _ = pair
    got = model(torch.as_tensor(x))
    for name in ("classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert np.asarray(want.valid).any()
    for name in ("boxes_xyxy", "scores", "masks"):
        close_scaled(getattr(got, name).numpy(),
                     np.asarray(getattr(want, name)), 1e-4)


def test_postprocess_lexsort_puts_x1_first():
    boxes = np.array([[5.0, 0, 10, 10], [1.0, 9, 10, 10], [1.0, 2, 10, 10]])
    args = (boxes, np.ones(3), np.zeros(3, int), np.ones(3, bool), (20, 20))
    got = P.postprocess_human_boxes(*args)
    np.testing.assert_array_equal(got, S.postprocess_human_boxes(*args))
    np.testing.assert_array_equal(got[:, :2], [[1.0, 2], [1.0, 9], [5.0, 0]])
    det = P.HumanDetector.__new__(P.HumanDetector)
    det.image_size = 1024
    assert det._scale(1080, 1920) == pytest.approx(1024 / 1920)
    assert det._scale(512, 512) == pytest.approx(2.0)


def test_converter_matches_skix_on_the_reference_layout():
    """A detectron2-layout state dict (every entry of
    ``cascade_reference_state_dict_spec``, a cls token on the position
    table) through both converters: the port's state_dict holds every
    parameter of the model, in its shape, and no other key, and equals
    skix's converted variables through the weight bridge tensor for
    tensor."""
    from skix_torch.convert import flax_to_state_dict

    kw = dict(embed_dim=32, depth=2, num_heads=2, window_size=2,
              global_grid=4, global_indexes=(1,))
    spec = P.cascade_reference_state_dict_spec(**kw)
    assert spec == S.cascade_reference_state_dict_spec(**kw)
    rng = np.random.default_rng(5)
    sd = {k: rng.standard_normal(s, dtype=np.float32)
          for k, s in spec.items()}
    got = P.convert_detectron2_cascade_vitdet(
        {k: torch.as_tensor(v) for k, v in sd.items()})
    want = flax_to_state_dict(S.convert_detectron2_cascade_vitdet(sd))
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in P.CascadeMaskRCNN(
            **KW, image_size=SIZE).state_dict().items()}
    assert set(got) == set(want) == set(shapes)
    for k in want:
        assert tuple(got[k].shape) == shapes[k], k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    assert shapes["net.pos_embed"] == (1, 14, 14, 32)
    np.testing.assert_array_equal(
        got["net.pos_embed"].numpy().reshape(196, 32),
        sd["backbone.net.pos_embed"][0, 1:])
