"""skix_torch.data.{video,grounding}, the association losses of
skix_torch.tracking.matcher and the training losses of
skix_torch.models.keypoint_rcnn against skix on the CPU: the same YTVIS
clips and collation from the same numpy ``Generator``, the same
``Datapoint`` after every filter and transform, and both association
losses and both keypoint R-CNN losses with their gradients within 1e-6."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

import skix.data.grounding as SG
import skix.data.video as SV
import skix_torch.data.grounding as PG
import skix_torch.data.video as PV


def _same(a, b, where="root"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _write_ytvis(root, T=7, hw=(24, 40)):
    """Two videos: masklets with polygon and RLE masks, one missing frames,
    a crowd annotation, an annotation of an unknown video."""
    import cv2

    from skix_torch.io.coco_export import mask_to_rle

    h, w = hw
    rng = np.random.default_rng(0)
    videos, anns = [], []
    for vid in (1, 2):
        names = []
        for t in range(T):
            name = f"v{vid}_{t:03d}.png"
            cv2.imwrite(str(root / name),
                        rng.integers(0, 255, (h, w, 3), np.uint8))
            names.append(name)
        videos.append({"id": vid, "file_names": names, "height": h,
                       "width": w})
    rle = np.zeros((h, w), bool)
    rle[3:9, 5:14] = True
    anns += [
        {"id": 7, "video_id": 1, "category_id": 2,
         "bboxes": [[2 + t, 3, 9, 8] for t in range(T)],
         "segmentations": [[[2 + t, 3, 11 + t, 3, 11 + t, 11, 2 + t, 11]]
                           for t in range(T)]},
        {"id": 3, "video_id": 1, "category_id": 1,
         "bboxes": [[20, 4, 6, 5] if t not in (2, 3) else None
                    for t in range(T)],
         "segmentations": [mask_to_rle(rle) if t % 2 else None
                           for t in range(T)]},
        {"id": 9, "video_id": 1, "category_id": 1, "iscrowd": 1,
         "bboxes": [[0, 0, 4, 4]] * T},
        {"id": 4, "video_id": 2, "category_id": 5,
         "bboxes": [[1, 1, 5, 5]] * (T - 2)},
        {"id": 5, "video_id": 99, "category_id": 1, "bboxes": []},
    ]
    path = root / "ytvis.json"
    path.write_text(json.dumps({
        "videos": videos, "annotations": anns,
        "categories": [{"id": 1}, {"id": 2}, {"id": 5}]}))
    return path


def test_video_clips_and_collation_match_skix(tmp_path):
    path = _write_ytvis(tmp_path)
    for kw in ({}, {"load_masks": False}, {"max_masklets": 1}):
        pd, sd = PV.VideoDataset(path, **kw), SV.VideoDataset(path, **kw)
        assert pd.ids == sd.ids and len(pd) == len(sd)
    pd, sd = PV.VideoDataset(path), SV.VideoDataset(path)
    for i in range(len(sd)):
        _same(pd.clip(i, [0, 3, 5]), sd.clip(i, [0, 3, 5]))
        for seed in range(3):
            _same(pd.sample_clip(i, np.random.default_rng(seed),
                                 num_frames=3, stride_max=4),
                  sd.sample_clip(i, np.random.default_rng(seed),
                                 num_frames=3, stride_max=4))
    clips = [sd.clip(0, [1, 2]), sd.clip(1, [4, 6])]
    for kw in ({}, {"max_objects": 1}, {"with_masks": False}):
        _same(PV.collate_clips(clips, **kw), SV.collate_clips(clips, **kw))
    for mod in (PV, SV):
        with pytest.raises(ValueError, match="share"):
            mod.collate_clips([clips[0], sd.clip(0, [1])])
    rec = {"image": clips[0]["images"][0], "boxes": clips[0]["boxes"][0],
           "masks": clips[0]["masks"][0], "cls": clips[0]["cls"],
           "image_id": 4}
    _same(PV.tile_image_clip(rec, 3), SV.tile_image_clip(rec, 3))
    _same(PV.tile_image_clip({**rec, "masks": None}, 2),
          SV.tile_image_clip({**rec, "masks": None}, 2))


@pytest.mark.parametrize("args", [(10, 4, 1, 5, True), (5, 4, 2, 6, True),
                                  (4, 4, 3, 3, False), (9, 1, 1, 5, True),
                                  (3, 4, 1, 5, True)])
def test_sample_clip_frames_matches_skix(args):
    n, k, lo, hi, rev = args
    def run(mod, seed):
        try:
            return mod.sample_clip_frames(n, np.random.default_rng(seed), k,
                                          lo, hi, rev)
        except ValueError as e:
            return str(e)
    for seed in range(8):
        _same(run(PV, seed), run(SV, seed))


def _dp(mod):
    """Two images, five objects, four queries (one geometric, one with no
    output, one non-exhaustive), as each package's dataclasses."""
    def obj(x1=0, y1=0, x2=10, y2=10, area=None, crowd=False):
        a = (x2 - x1) * (y2 - y1) if area is None else area
        return mod.GroundingObject(bbox=np.array([x1, y1, x2, y2],
                                                 np.float32),
                                   area=float(a), is_crowd=crowd)
    img0 = mod.GroundingImage(objects=[obj(), obj(5, 5, 20, 20),
                                       obj(0, 0, 0, 8)])
    img1 = mod.GroundingImage(objects=[obj(area=0.0), obj(crowd=True)])
    return mod.Datapoint(images=[img0, img1], find_queries=[
        mod.FindQuery("skier", image_id=0, object_ids_output=[0, 1]),
        mod.FindQuery("snow", image_id=0, object_ids_output=[2],
                      is_exhaustive=False, query_processing_order=2),
        mod.FindQuery("geometric", image_id=1, object_ids_output=[0],
                      input_bbox=np.array([0, 0, 5, 5], np.float32)),
        mod.FindQuery("empty", image_id=1, object_ids_output=[],
                      is_pixel_exhaustive=False,
                      query_processing_order=1)])


FILTERS = {
    "text": lambda m: m.FilterQueryWithText(["snow", "empty"]),
    "keep_max": lambda m: m.KeepMaxNumFindQueries(
        2, rng=np.random.default_rng(3)),
    "keep_max_pos": lambda m: m.KeepMaxNumFindQueries(
        2, retain_positive_queries=True, rng=np.random.default_rng(4)),
    "keep_max_pos_few": lambda m: m.KeepMaxNumFindQueries(
        1, retain_positive_queries=True, rng=np.random.default_rng(5)),
    "semantic": lambda m: m.KeepSemanticFindQueriesOnly(),
    "zero_box": lambda m: m.FilterZeroBoxQueries(),
    "too_many": lambda m: m.FilterFindQueriesWithTooManyOut(1),
    "empty_targets": lambda m: m.FilterEmptyTargets(),
    "instance": lambda m: m.FilterNonExhaustiveFindQueries("instance"),
    "pixel": lambda m: m.FilterNonExhaustiveFindQueries("pixel"),
    "geometric": lambda m: m.FilterInvalidGeometricQueries(),
    "crowds": lambda m: m.FilterCrowds(),
    "all": lambda m: m.FilterQueryWithText(["skier", "snow", "geometric",
                                            "empty"]),
    "no_stage_0": lambda m: m.FilterQueryWithText(["skier", "geometric"]),
}
TRANSFORMS = {
    "prefix": lambda m: m.AddPrefixSuffixToFindText(prefix="a ",
                                                    suffix="!"),
    "prefix_if": lambda m: m.AddPrefixSuffixToFindText(
        prefix="the ", condition_on_text=True,
        condition_text_list=[" Skier", "empty"]),
    "to_visual": lambda m: m.TextQueryToVisual(
        0.7, rng=np.random.default_rng(6)),
    "to_visual_keep": lambda m: m.TextQueryToVisual(
        1.0, keep_text_queries=True, rng=np.random.default_rng(7)),
    "remove_boxes": lambda m: m.RemoveInputBoxes(),
    "overwrite": lambda m: m.OverwriteTextQuery(
        "person", 0.5, rng=np.random.default_rng(8)),
}


@pytest.mark.parametrize("name", sorted(FILTERS) + sorted(TRANSFORMS))
def test_grounding_filters_match_skix(name):
    """Each filter through FlexibleFilterFindGetQueries (the remapping of
    stages, objects and images), each transform, on each package's own
    datapoint: equal datapoints or the same error."""
    out = []
    for mod in (PG, SG):
        try:
            if name in FILTERS:
                op = mod.FlexibleFilterFindGetQueries(FILTERS[name](mod))
            else:
                op = TRANSFORMS[name](mod)
            out.append(op(_dp(mod)))
        except (ValueError, AssertionError) as e:
            out.append((type(e).__name__, str(e)))
    _same(*out)
    disabled = [mod.FlexibleFilterFindGetQueries(
        mod.FilterCrowds(), enabled=False)(_dp(mod)) for mod in (PG, SG)]
    _same(*disabled)


def test_datapoint_from_coco_matches_skix():
    r = np.random.default_rng(9)
    rec = {"boxes": np.array([[1, 2, 8, 9], [3, 3, 3, 7]], np.float32),
           "masks": r.random((2, 12, 12)) < 0.5,
           "image": r.integers(0, 255, (12, 12, 3), np.uint8)}
    _same(PG.datapoint_from_coco(rec, "skier"),
          SG.datapoint_from_coco(rec, "skier"))
    rec["masks"] = None
    _same(PG.datapoint_from_coco(rec), SG.datapoint_from_coco(rec))


def _ids(r, B, Q, n_obj):
    ids = r.integers(0, n_obj, (B, Q))
    return np.where(r.random((B, Q)) < 0.3, -1, ids).astype(np.int32)


def _value_and_grads(p_fn, s_fn, logits, *rest, index=None):
    """The port's and skix's loss (or its ``index``-th output) and the
    gradient in the logits."""
    def pick(out):
        return out if index is None else out[index]
    lt = torch.as_tensor(logits, dtype=torch.float32).requires_grad_(True)
    got = pick(p_fn(lt, *[torch.as_tensor(x) for x in rest]))
    got.backward()
    want, g = jit0(jax.value_and_grad(lambda lg, *a: pick(s_fn(lg, *a))))(
        jnp.asarray(logits, jnp.float32), *map(jnp.asarray, rest))
    return float(got.detach()), float(want), lt.grad.numpy(), np.asarray(g)


ASSOC = {
    "plain": {},
    "fp": dict(use_fp_loss=True),
    "fp_new": dict(use_fp_loss=True, treat_fp_as_new_obj=True),
    "fp_exhaustive": dict(use_fp_loss=True, exhaustive=True),
}


@pytest.mark.parametrize("case", sorted(ASSOC))
def test_det2trk_assoc_loss_matches_skix(case):
    """Labels from shared GT ids (a duplicated track id: the first
    occurrence), a frame without tracks, ignored −1s; value and gradient
    within 1e-6."""
    from skix.tracking.matcher import det2trk_assoc_loss as S
    from skix_torch.tracking.matcher import det2trk_assoc_loss as P

    flags = {k: v for k, v in ASSOC[case].items() if k != "exhaustive"}
    r = np.random.default_rng(10)
    B, Qd, Qt = 3, 6, 5
    det, trk = _ids(r, B, Qd, 6), _ids(r, B, Qt, 6)
    trk[0, 1] = trk[0, 3] = det[0, 0] = 2        # two tracks share an id
    trk[2] = -1                                 # a frame without tracks
    logits = r.normal(size=(B, Qd, Qt + 2)).astype(np.float32) * 2
    names = ["matched_obj_ids_det", "matched_obj_ids_trk", "num_boxes"]
    rest = [det, trk, np.float32(4.0)]
    if flags.get("use_fp_loss"):
        names.append("det_logits")
        rest.append(r.normal(size=(B, Qd)).astype(np.float32))
    if ASSOC[case].get("exhaustive"):
        names.append("is_exhaustive")
        rest.append(np.array([True, False, True]))

    def call(fn):
        return lambda lg, *a: fn(lg, **dict(zip(names, a)), **flags)
    got, want, g_got, g_want = _value_and_grads(call(P), call(S), logits,
                                                *rest)
    assert want > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_got, g_want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("direction", [0, 1], ids=["det2trk", "trk2det"])
def test_tracking_by_detection_assoc_loss_matches_skix(direction):
    from skix.tracking.matcher import tracking_by_detection_assoc_loss as S
    from skix_torch.tracking.matcher import (
        tracking_by_detection_assoc_loss as P)

    r = np.random.default_rng(11)
    B, Qd, Qt = 3, 5, 4
    det, trk = _ids(r, B, Qd, 5), _ids(r, B, Qt, 5)
    det[1, 0] = det[1, 2] = trk[1, 1] = 4       # two detections share an id
    trk[2] = -1
    logits = r.normal(size=(B, Qd + 1, Qt + 1)).astype(np.float32) * 2
    got, want, g_got, g_want = _value_and_grads(
        P, S, logits, det, trk, np.float32(0.0), index=direction)
    assert want > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_got, g_want, atol=1e-6, rtol=0)


def test_keypoint_rcnn_losses_match_skix():
    """keypoint_head_loss (keypoints inside and outside their boxes,
    invisible ones, padded slots) and box_head_loss, each value and its
    gradients in the logits and the deltas within 1e-6."""
    from skix.models import keypoint_rcnn as S
    from skix_torch.models import keypoint_rcnn as P

    r = np.random.default_rng(12)
    B, N, Sz, K = 2, 3, 8, 17
    heat = r.normal(size=(B, N, Sz, Sz, K)).astype(np.float32)
    xy0 = r.uniform(0, 40, (B, N, 2))
    boxes = np.concatenate([xy0, xy0 + r.uniform(8, 30, (B, N, 2))],
                           -1).astype(np.float32)
    kpts = np.concatenate([r.uniform(-5, 75, (B, N, K, 2)),
                           r.integers(0, 3, (B, N, K, 1))], -1
                          ).astype(np.float32)
    valid = np.array([[True, True, False], [True, False, True]])
    got, want, g_got, g_want = _value_and_grads(
        P.keypoint_head_loss, S.keypoint_head_loss, heat, boxes, kpts, valid)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_got, g_want, atol=1e-6, rtol=0)

    scores = r.normal(size=(B, N, 2)).astype(np.float32)
    deltas = r.normal(size=(B, N, 4)).astype(np.float32)
    gt = boxes + r.normal(size=boxes.shape).astype(np.float32)
    for arg in (0, 1):
        order = [scores, deltas]
        def p_fn(x, other, *a, arg=arg):
            s, d = (x, other) if arg == 0 else (other, x)
            return P.box_head_loss(s, d, *a)

        def s_fn(x, other, *a, arg=arg):
            s, d = (x, other) if arg == 0 else (other, x)
            return S.box_head_loss(s, d, *a)
        got, want, g_got, g_want = _value_and_grads(
            p_fn, s_fn, order[arg], order[1 - arg], boxes, gt, valid)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(g_got, g_want, atol=1e-6, rtol=0)
