"""skix_torch's Keypoint R-CNN R50-FPN against skix's, on the CPU at 64 × 64
with skix's test settings (``d2_pre_nms_topk: 32``, 8 proposals).

The port's model draws its weights (``_torch_parity.port_variables``,
FrozenBN's four arrays kept as parameters) and hands skix the same values;
skix runs jitted, twice for the file: its ``__call__`` (the detections),
and its own ``backbone_forward``, ``propose`` and ``box_head`` (the raw
RPN heads, the proposals and the box head on them, before the second
NMS). Limits 1e-4, relative to the largest element where that exceeds 1
(pixels); the picks (top-k, NMS) equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import close_scaled, compile_once, port_variables

from skix.models import keypoint_rcnn as J
from skix_torch.models import keypoint_rcnn as P

rng = np.random.default_rng(77)
IMGS = rng.random((1, 64, 64, 3)).astype(np.float32)
KW = dict(pre_nms_topk=32, post_nms_topk=8, detections=4,
          score_threshold=0.1)
_STATE = {}


def _models():
    if not _STATE:
        pm = P.KeypointRCNN(**KW)
        v = port_variables(pm, seed=3)
        jm = J.KeypointRCNN(**KW)
        x = jnp.asarray(IMGS)
        H, W = IMGS.shape[1:3]

        def raw(m, images):
            feats, rpn = m.backbone_forward(images)
            shapes = [(f.shape[1], f.shape[2], st, sz) for f, st, sz in
                      zip(feats, (4, 8, 16, 32, 64), J.ANCHOR_SIZES)]
            out = []
            for b in range(images.shape[0]):
                props, _ = m.propose([(o[b], d[b]) for o, d in rpn], shapes)
                props = jnp.clip(props, 0, jnp.asarray([W, H, W, H]))
                rois = J.multilevel_roi_align([f[b] for f in feats], props, 7)
                out.append((props, *m.box_head(rois)))
            return rpn, out

        def both(v, x):
            return jm.apply(v, x), jm.apply(v, x, method=raw)

        _STATE.update(model=pm.eval(), want=compile_once(both, v, x)(v, x))
    return _STATE["model"], _STATE["want"]


def test_raw_rpn_and_box_heads_match_skix():
    model, (_, (rpn, per_image)) = _models()
    with torch.no_grad():
        got = model.raw_heads(torch.as_tensor(IMGS))
    for b, g in enumerate(got):
        for lv, (obj, deltas) in enumerate(rpn):
            close_scaled(g.rpn_logits[lv].numpy(), np.asarray(obj[b]).ravel(),
                         1e-4)
            close_scaled(g.rpn_deltas[lv].numpy(),
                         np.asarray(deltas[b]).reshape(-1, 4), 1e-4)
        props, scores, deltas = per_image[b]
        close_scaled(g.proposals.numpy(), props, 1e-4)
        close_scaled(g.cls_logits.numpy(), scores, 1e-4)
        close_scaled(g.box_deltas.numpy(), deltas, 1e-4)


def test_detections_match_skix():
    model, (want, _) = _models()
    with torch.no_grad():
        got = model(torch.as_tensor(IMGS))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    close_scaled(got.boxes_xyxy.numpy(), want.boxes_xyxy, 1e-4)
    close_scaled(got.scores.numpy(), want.scores, 1e-4)
    close_scaled(got.keypoints.numpy(), want.keypoints, 1e-4)


@pytest.mark.parametrize("size,stride", [(7, 4), (14, 8)])
def test_roi_align_matches_skix(size, stride):
    """skix's one-sample-per-bin RoIAlign, boxes inside, across and beyond
    the map's edges (the clamped base indices)."""
    feat = rng.normal(size=(12, 10, 5)).astype(np.float32)
    boxes = np.array([[3, 4, 30, 28], [-8, -3, 12, 50], [20, 2, 90, 60],
                      [5, 5, 5.5, 5.2]], np.float32)
    want = compile_once(lambda f, b: J.roi_align(f, b, size, stride),
                        feat, boxes)(feat, boxes)
    got = P.roi_align(torch.as_tensor(feat), torch.as_tensor(boxes), size,
                      stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_anchors_deltas_and_heatmap_decoding_match_skix():
    np.testing.assert_array_equal(P.level_anchors(3, 5, 8, 64.0),
                                  J.level_anchors(3, 5, 8, 64.0))
    anchors = P.level_anchors(2, 2, 16, 32.0)
    deltas = rng.normal(size=anchors.shape).astype(np.float32) * 3
    heat = rng.normal(size=(3, 6, 6, 17)).astype(np.float32)
    boxes = np.array([[0, 0, 20, 30], [5, 6, 7, 9], [10, 2, 40, 8]],
                     np.float32)
    fn = compile_once(lambda a, d, h, b: (
        J.apply_deltas(a, d, J.BBOX_REG_WEIGHTS),
        J.decode_keypoint_heatmaps(h, b)), anchors, deltas, heat, boxes)
    want_boxes, want_kpts = fn(anchors, deltas, heat, boxes)
    close_scaled(P.apply_deltas(torch.as_tensor(anchors),
                                torch.as_tensor(deltas),
                                P.BBOX_REG_WEIGHTS).numpy(), want_boxes, 1e-5)
    close_scaled(P.decode_keypoint_heatmaps(torch.as_tensor(heat),
                                            torch.as_tensor(boxes)).numpy(),
                 want_kpts, 1e-5)
