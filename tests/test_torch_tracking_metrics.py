"""skix_torch's tracking metrics (MOTA, HOTA, TETA, cgF1, video instance
AP, the suite) and ``UnchunkedGenerator`` against skix's, on seeded
tracks with identity switches, misses, false positives and empty frames.

Both are numpy on the same inputs: every value to 1e-9 (NaN equal to
NaN), every count and id equal."""

import numpy as np
import pytest


def _tracks(seed: int, T: int = 12, hw=(40, 56), masks: bool = True):
    """Per-frame (pred_boxes, pred_ids, pred_scores, gt_boxes, gt_ids,
    pred_masks, gt_masks): 3 ground-truth objects with drifting boxes;
    predictions jittered, one object's id switched halfway, one missed
    for a stretch, a false positive now and then, and empty frames."""
    r = np.random.default_rng(seed)
    H, W = hw
    start = r.uniform([2, 2], [W - 20, H - 16], (3, 2))
    size = r.uniform([8, 6], [16, 12], (3, 2))
    vel = r.uniform(-1.5, 1.5, (3, 2))
    out = {k: [] for k in ("pb", "pi", "ps", "gb", "gi", "pm", "gm")}
    for t in range(T):
        lo = start + vel * t
        gb = np.concatenate([lo, lo + size], 1)
        gi = np.arange(3) + 10
        if t in (4, 9):                      # an empty ground-truth frame
            gb, gi = gb[:0], gi[:0]
        pb = gb + r.normal(0, 1.0, gb.shape)
        pi = np.array([1, 2, 3])[:len(gb)] + (t >= T // 2) * np.array(
            [0, 5, 0])[:len(gb)]
        keep = np.ones(len(pb), bool)
        if 2 <= t <= 5 and len(pb):
            keep[2] = False                  # a miss
        pb, pi = pb[keep], pi[keep]
        if t % 3 == 0:                       # a false positive
            fp = np.array([[W - 9, 1, W - 2, 8]], float)
            pb, pi = np.concatenate([pb, fp]), np.append(pi, 40 + t)
        if t == 7:                           # an empty prediction frame
            pb, pi = pb[:0], pi[:0]
        out["pb"].append(pb)
        out["pi"].append(pi)
        out["ps"].append(r.uniform(0.3, 1.0, len(pb)))
        out["gb"].append(gb)
        out["gi"].append(gi)
        if masks:
            yy, xx = np.mgrid[:H, :W]

            def raster(b):
                x1, y1, x2, y2 = (b[:, i, None, None] for i in range(4))
                return (xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2)
            out["pm"].append(raster(pb))
            out["gm"].append(raster(gb))
    return out


def _same(got, want, where="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=0,
                                   atol=1e-9, err_msg=where)


@pytest.mark.parametrize("seed", [0, 1])
def test_tracking_eval_matches_skix(seed):
    from skix.metrics import tracking_eval as S
    from skix_torch.metrics import tracking_eval as P

    d = _tracks(seed)
    box_args = (d["pb"], d["pi"], d["gb"], d["gi"])
    _same(P.evaluate_tracking(*box_args), S.evaluate_tracking(*box_args))
    _same(P.evaluate_tracking(*box_args, iou_threshold=0.3),
          S.evaluate_tracking(*box_args, iou_threshold=0.3))
    _same(P.evaluate_hota(*box_args), S.evaluate_hota(*box_args))
    _same(P.evaluate_hota(*box_args, alphas=np.array([0.3, 0.6])),
          S.evaluate_hota(*box_args, alphas=np.array([0.3, 0.6])))
    mask_args = (d["pm"], d["pi"], d["gm"], d["gi"])
    _same(P.spatiotemporal_mask_iou(*mask_args),
          S.spatiotemporal_mask_iou(*mask_args))
    for scores in (d["ps"], {int(i): 0.1 * (int(i) % 7) for ids in d["pi"]
                             for i in ids}):
        _same(P.video_instance_ap(d["pm"], d["pi"], scores, d["gm"],
                                  d["gi"]),
              S.video_instance_ap(d["pm"], d["pi"], scores, d["gm"],
                                  d["gi"]))


def test_teta_and_cgf1_match_skix():
    from skix.metrics import cgf1 as SC
    from skix.metrics import teta as ST
    from skix_torch.metrics import cgf1 as PC
    from skix_torch.metrics import teta as PT

    d = _tracks(2, masks=False)
    r = np.random.default_rng(3)
    pc = [r.integers(0, 2, len(i)) for i in d["pi"]]
    gc = [np.arange(len(i)) % 2 for i in d["gi"]]
    args = (d["pb"], d["pi"], pc, d["gb"], d["gi"], gc)
    _same(PT.evaluate_teta(*args), ST.evaluate_teta(*args))
    for thr in (0.5, 0.8):
        _same(PC.evaluate_cgf1(d["pb"], d["ps"], d["gb"], threshold=thr),
              SC.evaluate_cgf1(d["pb"], d["ps"], d["gb"], threshold=thr))


@pytest.mark.parametrize("masks", [True, False])
def test_suite_matches_skix(masks):
    from skix.metrics.suite import evaluate_tracking_suite as skix_suite
    from skix_torch.metrics.suite import evaluate_tracking_suite

    d = _tracks(4, masks=masks)
    kw = dict(pred_masks=d["pm"], gt_masks=d["gm"]) if masks else {}
    args = (d["pb"], d["pi"], d["ps"], d["gb"], d["gi"])
    got = evaluate_tracking_suite(*args, **kw)
    _same(got, skix_suite(*args, **kw))
    assert ("mask_AP" in got) == masks
    # every frame empty on both sides
    empty = [np.zeros((0, 4))] * 3
    ids = [np.zeros(0, int)] * 3
    _same(evaluate_tracking_suite(empty, ids, ids, empty, ids),
          skix_suite(empty, ids, ids, empty, ids))


def test_unchunked_generator_matches_skix():
    from skix.models.generators import UnchunkedGenerator as Skix
    from skix_torch.models.generators import UnchunkedGenerator

    r = np.random.default_rng(5)
    p2 = [r.normal(size=(T, 17, 2)) for T in (9, 30)]
    p3 = [r.normal(size=(T, 17, 3)) for T in (9, 30)]
    for poses_3d in (p3, None):
        got = list(UnchunkedGenerator(p2, poses_3d, 27))
        want = list(Skix(p2, poses_3d, 27))
        assert len(got) == len(want) == 2
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype and gx.shape == wx.shape
            np.testing.assert_array_equal(gx, wx)
            assert (gy is None) == (wy is None)
            if gy is not None:
                np.testing.assert_array_equal(gy, wy)
