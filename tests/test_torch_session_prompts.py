"""skix_torch's video session with point and box prompts against skix on
the CPU, on the committed trained ``tests/fixtures/tracker_tiny.npz`` (its
detector with a grafted geometry branch, ``_torch_parity.graft_geometry``)
and the fixture script's synthetic clips: the geometry slots of
``add_prompt`` (accumulation, overflow, normalized xywh through
``handle_request``, ``reset_session``, ``session_stats``), the masklet
session streamed by ``handle_stream_request`` in both directions from a
prompted frame, with prompts on two frames, geometry alone (the ``"visual"``
text prompt), and ``track_masklets``.

Tolerances: slots equal (host arithmetic); masklet ids, active flags and
mask pixels equal; scores and boxes to 1e-4 of their scale; the lifecycle's
integer and bool outputs equal, its floats to 1e-5.

skix's masklet programs are module-level jits at XLA's default level; the
file swaps them for level-0 compiles (``_torch_parity.cheap_jit``), and
its fused frame step for the three programs its geometry path runs (the
same operations, one tracker compile fewer).
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from _torch_parity import _CHEAP, cheap_jit, close_scaled, graft_geometry, jit0

from skix_torch.convert import flax_to_state_dict, load_into

FIXTURE = Path(__file__).parent / "fixtures" / "tracker_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
MASKLET = dict(max_objects=4, max_dets=6, score_threshold_detection=0.25,
               new_det_thresh=0.45, det_nms_thresh=0.6, assoc_iou_thresh=0.2,
               trk_assoc_iou_thresh=0.2, hotstart_delay=1000,
               hotstart_unmatch_thresh=4, hotstart_dup_thresh=2)
T = 4


def _unfused_frame_step(SM):
    """skix's ``_full_frame_step`` (prep → detector → tracker core) as its
    three parts, as the geometry frames run them."""
    def step(detector, tracker, cfg, fill_holes, is_u8, det_size, trk_size,
             det_vars, trk_vars, frame, text, state, banks, text_pad=None):
        det_in, tin = SM._prep_frame(frame, is_u8, det_size, trk_size)
        det = SM._detect_with_geometry(
            detector, det_vars, det_in, text[None],
            {} if text_pad is None else {"text_pad_mask": text_pad[None]})
        return SM._masklet_frame_core(tracker, cfg, fill_holes, trk_vars, tin,
                                      det.boxes_cxcywh[0], det.scores[0],
                                      det.mask_logits[0], state, banks)
    return step


@pytest.fixture(scope="module")
def models():
    """skix's (detector, grafted tree, tracker, tree) and the port's
    (detector with the same geometry branch, tracker), with skix's masklet
    jits at level 0."""
    import make_tracker_fixture as mtf
    import skix.tracking.masklet as SM
    from skix.tracking.memory_tracker import MaskMemoryTracker as SkixTrk
    from skix.tracking.sam3_detector import Sam3Detector as SkixDet
    from skix_torch.tracking.fixture import TRACKER, load_tracker_fixture

    mp = pytest.MonkeyPatch()
    for name, static in (("_scan_frame_chunk", tuple(range(7))),
                         ("_masklet_frame_core", (0, 1, 2)),
                         ("_prep_frame", (1, 2, 3)),
                         ("_detect_with_geometry", (0,)),
                         ("_upsample_pack_masks", (1, 2))):
        mp.setattr(SM, name, cheap_jit(getattr(SM, name), static))
    mp.setattr(SM, "_full_frame_step", _unfused_frame_step(SM))
    det_vars, trk_vars = mtf.load_fixture(FIXTURE)
    det_vars = graft_geometry(det_vars)
    det, trk = load_tracker_fixture(FIXTURE, device="cpu")
    det.geometry_encoder = det.make_geometry_encoder()
    load_into(det, flax_to_state_dict(det_vars))
    yield ((SkixDet.tiny(img_size=112), det_vars, SkixTrk(**TRACKER),
            trk_vars), (det, trk))
    mp.undo()


@pytest.fixture(scope="module")
def clip():
    import make_tracker_fixture as mtf

    frames, boxes, _, _ = mtf.synth_clip(20_001, T=T, n_obj=2, min_sep=1.5)
    return (frames * 255).astype(np.uint8), boxes


def _predictors(models, tracker=True):
    from skix.tracking.masklet import MaskletConfig as SkixCfg
    from skix.tracking.session import VideoPredictor as Skix
    from skix_torch.tracking.masklet import MaskletConfig
    from skix_torch.tracking.session import VideoPredictor

    from skix.tracking.lifecycle import TrackerConfig as SkixTrkCfg
    from skix_torch.tracking.lifecycle import TrackerConfig

    (sdet, svars, strk, stv), (det, trk) = models
    box_cfg = dict(max_objects=4, det_score_threshold=0.0)
    sk = Skix(sdet, svars, tracker=(strk, stv) if tracker else None,
              masklet_cfg=SkixCfg(**MASKLET), smoke_prompts=True,
              batch_size=2, tracker_cfg=SkixTrkCfg(**box_cfg))
    sk._detect = jax.jit(sk._detect_batch, compiler_options=_CHEAP)
    sk._step = jax.jit(sk._step.__wrapped__, compiler_options=_CHEAP)
    pp = VideoPredictor(det, trk if tracker else None,
                        MaskletConfig(**MASKLET), smoke_prompts=True,
                        batch_size=2, tracker_cfg=TrackerConfig(**box_cfg))
    return sk, pp


def _same_stream(got, want):
    assert [o["frame_index"] for o in got] == [o["frame_index"] for o in want]
    for g, w in zip(got, want):
        g, w = g["outputs"], w["outputs"]
        assert set(g) == set(w)
        for k, a in w.items():
            if a.dtype.kind == "f":
                close_scaled(g[k], a, 1e-4)
            else:          # ids, flags, mask pixels
                np.testing.assert_array_equal(g[k], a, err_msg=k)


def test_geometry_slots_match_skix(models, caplog):
    """Slots accumulate per frame, overflow drops the rest with a warning,
    protocol boxes are normalized xywh (a 56 × 40 frame), default labels 1,
    ``reset_session`` clears them; ``session_stats``."""
    sk, pp = _predictors(models, tracker=False)
    frames = np.zeros((3, 40, 56, 3), np.uint8)
    boxes = [[10 / 56, 8 / 40, 20 / 56, 16 / 40], [0.5, 0.5, 0.25, 0.25],
             [0.1, 0.2, 0.3, 0.4]]
    for p in (sk, pp):
        sid = p.handle_request({"type": "start_session", "frames": frames,
                                "session_id": "clip"})["session_id"]
        assert p.handle_request({
            "type": "add_prompt", "session_id": sid, "frame_index": 1,
            "text": "person", "bounding_boxes": boxes,
            "bounding_box_labels": [1, 0, 1]}) == {"frame_index": 1}
        p.handle_request({"type": "add_prompt", "session_id": sid,
                          "frame_index": 1, "bounding_boxes": boxes[:2]})
        for k in range(3):
            p.add_prompt(sid, frame_idx=2, points=[[5.0 + k, 7.0], [30, 20],
                                                   [50, 39]],
                         point_labels=[1, 0, 1] if k else None)
        p.remove_object(sid, 3)
    for f in (1, 2):
        g, w = pp.sessions["clip"].geometry[f], sk.sessions["clip"].geometry[f]
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    g = pp.sessions["clip"].geometry[1]
    np.testing.assert_allclose(g["boxes"][0], [20 / 56, 16 / 40, 20 / 56,
                                               16 / 40], rtol=1e-6)
    assert g["box_valid"].all() and g["box_labels"].tolist() == [1, 0, 1, 1]
    assert pp.sessions["clip"].geometry[2]["point_valid"].sum() == 8
    assert any("slots full" in r.getMessage() for r in caplog.records
               if r.name == "skix_torch.tracking.session")
    assert pp.session_stats("clip") == sk.session_stats("clip") == {
        "frames": 3, "prompts": ["person"], "removed_ids": [3],
        "geometry_frames": [1, 2]}
    for p in (sk, pp):
        p.handle_request({"type": "reset_session", "session_id": "clip"})
        assert p.session_stats("clip")["geometry_frames"] == []
        p.handle_request({"type": "close_session", "session_id": "clip"})
        assert "clip" not in p.sessions
        with pytest.raises(RuntimeError, match="invalid request type"):
            p.handle_request({"type": "nonsense"})
        with pytest.raises(RuntimeError, match="invalid request type"):
            next(p.handle_stream_request({"type": "nonsense"}))


@pytest.fixture(scope="module")
def streams(models, clip):
    """The masklet session through the request protocol: a text prompt
    with a normalized box on frame 0 and two clicks on frame 1, streamed
    in both directions from frame 1 (frames 2-3 carry no geometry); then,
    reset, a click alone on frame 1 streamed forward ("visual"). Both
    packages' yields."""
    frames, boxes = clip
    cx, cy, w, h = boxes[0, 0]
    xywh = [[cx - w / 2, cy - h / 2, w, h]]
    cx, cy = boxes[1, 1, :2] * 112
    out = {}
    for side, p in zip(("skix", "port"), _predictors(models)):
        sid = p.handle_request({"type": "start_session",
                                "frames": frames})["session_id"]
        p.handle_request({"type": "add_prompt", "session_id": sid,
                          "text": "person", "frame_index": 0,
                          "bounding_boxes": xywh,
                          "bounding_box_labels": [1]})
        p.handle_request({"type": "add_prompt", "session_id": sid,
                          "frame_index": 1,
                          "points": [[cx, cy], [5.0, 5.0]],
                          "point_labels": [1, 0]})
        both = list(p.handle_stream_request({
            "type": "propagate_in_video", "session_id": sid,
            "start_frame_index": 1}))
        p.handle_request({"type": "reset_session", "session_id": sid})
        p.add_prompt(sid, frame_idx=1, points=[[cx, cy]])
        alone = list(p.handle_stream_request({
            "type": "propagate_in_video", "session_id": sid,
            "start_frame_index": 1, "max_frame_num_to_track": 2,
            "propagation_direction": "forward"}))
        out[side] = both, alone, p.session_stats(sid)
    return out


def test_masklet_stream_both_ways_matches_skix(streams):
    got, want = streams["port"][0], streams["skix"][0]
    assert [o["frame_index"] for o in got] == [1, 2, 3, 1, 0]
    _same_stream(got, want)
    assert any(o["outputs"]["active"].any() for o in got)


def test_geometry_alone_prompts_visual(streams):
    got, want = streams["port"][1], streams["skix"][1]
    assert [o["frame_index"] for o in got] == [1, 2]
    _same_stream(got, want)
    assert streams["port"][2] == streams["skix"][2]
    assert streams["port"][2]["prompts"] == ["visual"]


def test_track_masklets_matches_skix():
    """The lifecycle over a clip's detections alone: noisy ground-truth
    discs as detection logits, a dropped detection, a late object."""
    import make_tracker_fixture as mtf
    from skix.tracking.masklet import MaskletConfig as SkixCfg
    from skix.tracking.masklet import track_masklets as skix_track
    from skix_torch.tracking.masklet import MaskletConfig, track_masklets

    _, _, masks, valid = mtf.synth_clip(20_002, T=8, n_obj=3, min_sep=1.5)
    r = np.random.default_rng(0)
    grid = np.stack([mtf.jax_resize(m, 28, 28) for m in
                     masks.reshape(-1, 112, 112)]).reshape(8, 3, 28, 28)
    logits = np.where(grid, 8.0, -8.0) + r.normal(0, 2, grid.shape)
    logits = np.concatenate([logits, r.normal(-6, 2, (8, 1, 28, 28))], 1
                            ).astype(np.float32)
    scores = r.uniform(0.5, 0.9, (8, 4)).astype(np.float32)
    det_valid = np.concatenate([valid, np.zeros((8, 1), bool)], 1)
    det_valid[2, 0] = False
    det_valid[:3, 2] = False
    kw = dict(MASKLET, max_dets=4, hotstart_delay=2)
    want = jit0(lambda a, b, c: skix_track(a, b, c, SkixCfg(**kw)))(
        logits, scores, det_valid)
    got = track_masklets(logits, scores, det_valid, MaskletConfig(**kw))
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)
    assert got["spawn"].any() and got["active"][-1].sum() >= 2


@pytest.fixture(autouse=True)
def _warnings(caplog):
    caplog.set_level(logging.WARNING)
