"""skix_torch's compact front path against skix's, on the CPU: the slot
lifecycle, the detection post-processing, the byte-level text encoder,
the compact ``DetrDetector``, the box-level session and the stage's
``model: compact`` CLI.

One tiny compact configuration serves the file: a 64 px image in 16 px
patches (16 tokens), 32 wide, 2 blocks of 2 heads, 8 queries, one decoder
block, 16-dim prompts; seeded random flax variables, loaded into the
port through the weight bridge. skix's ``VideoPredictor`` on them (its
detector and lifecycle step compiled once, at the stage's batch) serves
the session twin and, in place of the one skix's stage would build from
the same checkpoint, the CLI twin.

Tolerances: 1e-4 in float32, relative to an array's largest element where
that exceeds 1 (boxes in pixels); slot ids, hits, confirmations, activity
and the stage's id and activity files equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import (assert_same_outputs, close_scaled, jit0,
                           random_variables)

from skix_torch.tracking import lifecycle as L

DET = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
           num_queries=8, decoder_depth=1, prompt_dim=16)
STAGE = dict(img_size=64, patch_size=16, embed_dim=32, vit_depth=2,
             num_heads=2, num_queries=8, decoder_depth=1, prompt_dim=16,
             max_objects=4, det_score_threshold=0.5, min_hits_to_confirm=2,
             batch_size=3)
TRK = dict(max_objects=4, det_score_threshold=0.5, min_hits_to_confirm=2)
T, H, W = 5, 48, 80


def _stream(seed, T=12, N=6):
    """Detections that move, vanish and return: boxes drifting a few
    pixels a frame, scores around the thresholds, a fifth invalid."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 60, (N, 2))
    wh = rng.uniform(8, 20, (N, 2))
    drift = rng.normal(0, 2, (N, 2))
    boxes = np.stack([np.concatenate([base + t * drift, base + t * drift + wh],
                                     -1) for t in range(T)]).astype(np.float32)
    scores = rng.uniform(0.1, 0.9, (T, N)).astype(np.float32)
    valid = rng.random((T, N)) > 0.2
    return boxes, scores, valid


def test_lifecycle_matches_skix_frame_by_frame():
    """The whole slot state (ids, hits, ages, misses, confirmations, boxes,
    keep-alive) after every frame, and ``track_sequence``'s outputs."""
    from skix.tracking import lifecycle as SL

    scfg = SL.TrackerConfig(**TRK)
    pcfg = L.TrackerConfig(**TRK)
    boxes, scores, valid = _stream(1)
    step = jit0(lambda st, b, s, v: SL.tracker_step(st, b, s, v, scfg))
    ss, ps = SL.init_tracker_state(scfg), L.init_tracker_state(pcfg)
    spawned = 0
    for t in range(len(boxes)):
        ss, _ = step(ss, boxes[t], scores[t], valid[t])
        ps, _ = L.tracker_step(ps, torch.as_tensor(boxes[t]),
                               torch.as_tensor(scores[t]),
                               torch.as_tensor(valid[t]), pcfg)
        for name in ("active", "confirmed", "hits", "age", "missing",
                     "obj_id", "next_id"):
            np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                          np.asarray(getattr(ss, name)),
                                          err_msg=f"{name} at frame {t}")
        for name in ("bbox", "score", "keep_alive"):
            close_scaled(getattr(ps, name).numpy(),
                         np.asarray(getattr(ss, name)), 1e-5)
        spawned = int(ps.next_id)
    assert spawned > TRK["max_objects"]      # slots were freed and reused
    got = L.track_sequence(torch.as_tensor(boxes), torch.as_tensor(scores),
                           torch.as_tensor(valid), pcfg)
    want = SL.track_sequence(boxes, scores, valid, scfg)
    for k in want:
        close_scaled(got[k].numpy(), np.asarray(want[k]), 1e-5)


def test_postprocess_detections_matches_skix():
    from skix.tracking.postprocess import postprocess_detections as skix_pp
    from skix_torch.tracking.postprocess import postprocess_detections

    rng = np.random.default_rng(2)
    boxes = rng.uniform(0.1, 0.9, (2, 10, 4)).astype(np.float32)
    logits = rng.normal(size=(2, 10)).astype(np.float32)
    logits[0, 3] = logits[0, 7]                 # a tie: the lower index
    presence = rng.normal(size=(2,)).astype(np.float32)
    masks = rng.normal(size=(2, 10, 6, 8)).astype(np.float32)
    for kw in (dict(target_size=(24, 40), max_dets=5,
                    detection_threshold=0.3),
               dict(target_size=None, max_dets=0, use_presence=False)):
        want = jit0(lambda *a, kw=kw: skix_pp(*a, **kw))(
            boxes, logits, presence, masks)
        got = postprocess_detections(*(torch.as_tensor(a) for a in
                                       (boxes, logits, presence, masks)),
                                     **kw)
        for name in ("masks", "valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("boxes_xyxy", "scores"):
            close_scaled(getattr(got, name).numpy(),
                         np.asarray(getattr(want, name)), 1e-5)


def test_text_encoder_matches_skix():
    from skix.tracking import text_encoder as ST
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.tracking import text_encoder as PT

    kw = dict(dim=32, depth=2, num_heads=4, out_dim=16)
    smod = ST.TextEncoder(**kw)
    v = random_variables(smod, np.random.default_rng(3),
                         jnp.zeros((1, 32), jnp.int32))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    texts = ["person", "snow", "a skier in red"]
    np.testing.assert_array_equal(PT.tokenize_batch(texts),
                                  ST.tokenize_batch(texts))
    model = PT.TextEncoder(**kw).eval()
    assert not load_into(model, flax_to_state_dict(v))
    close_scaled(PT.encode_texts(model, texts).numpy(),
                 np.asarray(ST.encode_texts(smod, v, texts)), 1e-5)


@pytest.fixture(scope="module")
def compact(tmp_path_factory):
    """The port's compact detector with random weights, their skix
    checkpoint, and skix's compact predictor on the same weights."""
    from skix.pipelines.videopose3d import save_checkpoint
    from skix.tracking import DetrDetector as SkixDetr
    from skix.tracking import TrackerConfig, VideoPredictor
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.tracking.detector import DetrDetector

    smod = SkixDetr(**DET)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        random_variables(smod, np.random.default_rng(4),
                         jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16))))
    model = DetrDetector(**DET).eval()
    assert not load_into(model, flax_to_state_dict(variables))
    path = tmp_path_factory.mktemp("compact") / "detr.npz"
    save_checkpoint(str(path), variables)
    pred = VideoPredictor(smod, variables, TrackerConfig(**TRK),
                          batch_size=STAGE["batch_size"])
    return model, path, pred


def _frames(seed):
    return np.random.default_rng(seed).integers(0, 255, (T, H, W, 3),
                                                dtype=np.uint8)


def test_detector_matches_skix(compact):
    """Boxes, scores, query embeddings and mask logits, with and without a
    prompt."""
    from skix.tracking.detector import embed_text_prompt as skix_embed
    from skix_torch.tracking.detector import embed_text_prompt

    model, _, pred = compact
    x = np.random.default_rng(5).random((3, 64, 64, 3)).astype(np.float32)
    prompt = np.stack([embed_text_prompt(t, 16)
                       for t in ("person", "snow", "person")])
    np.testing.assert_array_equal(prompt[1], np.asarray(skix_embed("snow",
                                                                   16)))
    apply = jit0(pred.detector.apply)
    for p in (prompt, None):
        want = apply(pred.variables, x, p)
        with torch.no_grad():
            got = model(torch.as_tensor(x),
                        None if p is None else torch.as_tensor(p))
        for name in want._fields:
            close_scaled(getattr(got, name).numpy(),
                         np.asarray(getattr(want, name)), 1e-4)


def test_session_box_tracking_matches_skix(compact):
    """``propagate_in_video`` forward and backward on a 5-frame clip in
    batches of 3 (the last padded), with an object removed: every
    frame's slot outputs."""
    from skix_torch.tracking.lifecycle import TrackerConfig
    from skix_torch.tracking.session import VideoPredictor

    model, _, want_pred = compact
    got_pred = VideoPredictor(model, tracker_cfg=TrackerConfig(**TRK),
                              batch_size=STAGE["batch_size"])
    frames = _frames(6)
    outs = []
    for pred in (want_pred, got_pred):
        sid = pred.start_session(frames)
        pred.add_prompt(sid, "person")
        pred.remove_object(sid, 1)
        outs.append([o for d in ("forward", "backward") for o in
                     pred.propagate_in_video(sid, start_frame_idx=2,
                                             propagation_direction=d)])
    want, got = outs
    assert [o["frame_index"] for o in got] == [o["frame_index"]
                                               for o in want] == [2, 3, 4,
                                                                  2, 1, 0]
    assert any(o["outputs"]["active"].any() for o in got)
    for g, w in zip(got, want):
        assert set(g["outputs"]) == set(w["outputs"])
        for k, a in w["outputs"].items():
            if a.dtype.kind in "fc":
                close_scaled(g["outputs"][k], a, 1e-4)
            else:
                np.testing.assert_array_equal(g["outputs"][k], a, err_msg=k)


def test_compact_cli_matches_skix(compact, tmp_path, monkeypatch):
    """The stage with ``model: compact`` through skix's and the port's CLI
    on the same video and checkpoint: the box files (no masks) and the
    summary."""
    import skix.pipelines.prepare_front_results as skix_stage
    from skix_torch.io.video import write_video
    from skix_torch.pipelines.prepare_front_results import main as port_main

    _, ckpt, pred = compact
    monkeypatch.setattr(skix_stage, "build_predictor", lambda cfg: pred)
    write_video(tmp_path / "front" / "p01" / "clip.mp4", _frames(7), fps=10)
    outs = {}
    for side, fn in (("skix", skix_stage.main), ("port", port_main)):
        cdir = tmp_path / f"cfg_{side}"
        cdir.mkdir()
        body = {"paths": {"video_root": str(tmp_path / "front"),
                          "out_root": str(tmp_path / side)},
                "model": "compact", "checkpoint": str(ckpt),
                "prompts": ["person", "snow"], **STAGE,
                **({"device": "cpu"} if side == "port" else {})}
        (cdir / "prepare_front_results.yaml").write_text("\n".join(
            f"{k}: {json.dumps(v)}" for k, v in body.items()) + "\n")
        fn([f"--config-dir={cdir}"])
        outs[side] = tmp_path / side
    names = sorted(p.name for p in (outs["port"] / "p01").iterdir())
    assert "snow_masks.npy" not in names and "person_valid.npy" in names
    assert_same_outputs(outs["skix"] / "p01", outs["port"] / "p01",
                        atol=1e-4, scaled=True)
    summary = json.loads((outs["port"] / "front_summary.json").read_text())
    assert summary == json.loads((outs["skix"]
                                  / "front_summary.json").read_text())
    assert summary["p01/clip"]["person"]["masks_saved"] is False


def test_session_box_tracking_with_a_sam3_detector():
    """A Sam3Detector without a memory tracker takes the box-level path,
    as in skix: each batch of frames resized to the detector's size (the
    last batch padded), its normalized cxcywh boxes scaled to the frame,
    the lifecycle stepped frame by frame on them."""
    from skix_torch.tracking.detector import embed_text_prompt
    from skix_torch.tracking.lifecycle import TrackerConfig
    from skix_torch.tracking.sam3_detector import Sam3Detector
    from skix_torch.tracking.session import VideoPredictor
    from skix_torch.utils.image import resize

    det = Sam3Detector.tiny()
    det.init_weights(torch.Generator().manual_seed(5))
    det.eval()
    cfg = TrackerConfig(max_objects=4, det_score_threshold=0.0)
    pred = VideoPredictor(det, tracker_cfg=cfg, batch_size=3,
                          smoke_prompts=True)
    frames = _frames(8)
    sid = pred.start_session(frames)
    pred.add_prompt(sid, "snow")
    got = list(pred.propagate_in_video(sid))
    prompt = torch.as_tensor(np.tile(embed_text_prompt("snow", 64)[None],
                                     (4, 1)))[None]
    imgs = resize(torch.as_tensor(frames, dtype=torch.float32) / 255.0,
                  (T, 112, 112, 3), "bilinear")
    with torch.no_grad():
        out = det(imgs, prompt.expand(T, -1, -1))
    cx, cy, w, h = out.boxes_cxcywh.unbind(-1)
    boxes = torch.stack([(cx - w / 2) * 112, (cy - h / 2) * 112,
                         (cx + w / 2) * 112, (cy + h / 2) * 112], -1)
    boxes = boxes * torch.tensor([W / 112, H / 112] * 2)
    state = L.init_tracker_state(cfg)
    for t in range(T):
        state, want = L.tracker_step(state, boxes[t], out.scores[t],
                                     torch.ones(boxes.shape[1], dtype=bool),
                                     cfg)
        assert got[t]["frame_index"] == t
        for k, v in want.items():
            close_scaled(got[t]["outputs"][k], v.numpy(), 1e-4)
    assert any(o["outputs"]["active"].any() for o in got)
