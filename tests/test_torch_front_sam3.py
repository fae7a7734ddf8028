"""The prepare_front_results stage in the reference SAM3 configuration:
skix's stage CLI and the port's on the same video with the same
checkpoints, written by this test: the tiny Sam3Detector (one fusion and
one decoder layer) with ``rope_style: sam3`` (its pretrain-sized position
table), the tracker of
``tests/test_torch_front_results.py``, and a tiny CLIP ``VETextEncoder``
(width 32, 2 heads, 1 layer, context 16, CLIP's vocabulary) whose
checkpoint ``clip.checkpoint`` names. Text prompts then go through the
CLIP tower: 16 tokens of which 13 are padding, so the pad masks of the
fusion encoder, the decoder and the prompt pooling are exercised.

skix's stage builds the full-size tower and a 77-token tokenizer whatever
the checkpoint holds (``skix/pipelines/prepare_front_results.py:107-112``,
which cannot run together: ``tests/test_torch_clip_text.py``); the skix side
here gets the tiny tower and a tokenizer of its context by patching those
two names. The port's stage takes the tower's shape from ``clip.encoder``.

Tolerances as ``tests/test_torch_front_results.py``: the slot lifecycle
exactly, the scores to 1e-5, the boxes to one pixel of the tracker grid in
frame pixels, the masks pixel by pixel in at least 99.9 % of pixels.
"""

import functools
import json

import numpy as np
import pytest

import jax.numpy as jnp
from _torch_parity import random_variables

T, H, W = 4, 48, 64
PROMPTS = ("person", "snow")
TRACKER = dict(features=16, num_heads=2, mem_slots=3)
DETECTOR = dict(img_size=112, patch_size=14, backbone_dim=64,
                backbone_depth=2, backbone_heads=2, mlp_ratio=4.0,
                window_size=4, global_att_blocks=[1], d_model=64,
                num_queries=12, encoder_layers=1, decoder_layers=1,
                rope_style="sam3", pretrain_img_size=56)
CLIP = dict(width=32, heads=2, layers=1, context_length=16, vocab_size=49408)


def _stage_cfg(vid_root, out_root, root):
    return {"paths": {"video_root": str(vid_root), "out_root": str(out_root)},
            "model": "sam3", "prompts": list(PROMPTS), "detector": DETECTOR,
            "detector_checkpoint": str(root / "det.npz"),
            "tracker": TRACKER, "tracker_checkpoint": str(root / "trk.npz"),
            "clip": {"checkpoint": str(root / "clip.npz"), "encoder": CLIP},
            "max_objects": 4, "max_dets": 6, "det_score_threshold": 0.0,
            "new_det_thresh": 0.0, "save_mask_size": 24, "max_frames": None,
            "overlay_video": False}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    import skix.tracking.clip_text as skix_clip_text
    import skix.tracking.clip_tokenizer as skix_clip_tokenizer
    import yaml
    from skix.io.video import write_video
    from skix.pipelines.prepare_front_results import main as skix_main
    from skix.pipelines.videopose3d import save_checkpoint
    from skix.tracking.clip_text import VETextEncoder
    from skix.tracking.memory_tracker import MaskMemoryTracker, init_memory
    from skix.tracking.sam3_detector import Sam3Detector
    from skix_torch.config import config_from_mapping
    from skix_torch.pipelines.prepare_front_results import main as torch_main

    root = tmp_path_factory.mktemp("front_sam3_twin")
    rng = np.random.default_rng(0)
    vid_root = root / "front_raw"
    (vid_root / "p01").mkdir(parents=True)
    write_video(vid_root / "p01" / "clip.mp4",
                rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8), fps=10)

    det_kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in DETECTOR.items()}
    det = Sam3Detector(**det_kw)
    det_v = random_variables(det, rng, jnp.zeros((1, 112, 112, 3)),
                             jnp.zeros((1, 16, 64)),
                             jnp.zeros((1, 16), bool))
    assert det_v["params"]["backbone"]["pos_embed"].shape[1:3] == (4, 4)
    trk = MaskMemoryTracker(**TRACKER)
    trk_v = random_variables(trk, rng, jnp.zeros((1, 112, 112, 3)),
                             init_memory(3, 14, 14, 16), method=trk.step)
    enc = VETextEncoder(d_model=64, **CLIP)
    clip_v = random_variables(enc, rng, jnp.zeros((1, 16), jnp.int32))
    for name, v in (("det", det_v), ("trk", trk_v), ("clip", clip_v)):
        save_checkpoint(str(root / f"{name}.npz"), v)

    cdir = root / "cfg"
    cdir.mkdir()
    (cdir / "prepare_front_results.yaml").write_text(yaml.safe_dump(
        _stage_cfg(vid_root, root / "skix_out", root)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(skix_clip_text, "VETextEncoder",
                   functools.partial(VETextEncoder, **CLIP))
        mp.setattr(skix_clip_tokenizer, "ClipTokenizer", functools.partial(
            skix_clip_tokenizer.ClipTokenizer, context_length=16))
        skix_main([f"--config-dir={cdir}"])
    torch_main(config_from_mapping(dict(
        _stage_cfg(vid_root, root / "torch_out", root), device="cpu")))
    return root / "skix_out", root / "torch_out"


def _load(out, name):
    return np.load(out / "p01" / name)


def test_same_files(outputs):
    skix_out, torch_out = outputs
    want = sorted(p.name for p in (skix_out / "p01").iterdir())
    got = sorted(p.name for p in (torch_out / "p01").iterdir())
    assert got == want and "snow_masks.npy" in got
    assert (json.loads((torch_out / "front_summary.json").read_text())
            == json.loads((skix_out / "front_summary.json").read_text()))
    spans = json.loads((torch_out / "front_timing.json").read_text())
    assert spans["clip"]["count"] == len(PROMPTS)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_lifecycle_and_scores(outputs, prompt):
    for kind in ("active", "obj_ids"):
        got, want = (_load(o, f"{prompt}_{kind}.npy") for o in outputs)
        assert got.shape == want.shape == (T, 4)
        np.testing.assert_array_equal(got, want)
    for kind in ("scores", "tracker_scores"):
        got, want = (_load(o, f"{prompt}_{kind}.npy") for o in outputs)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_boxes_and_masks(outputs, prompt):
    got, want = (_load(o, f"{prompt}_bboxes.npy") for o in outputs)
    np.testing.assert_allclose(got, want, atol=W / 14 + 1e-3, rtol=0)
    got, want = (_load(o, f"{prompt}_masks.npy") for o in outputs)
    assert got.shape == want.shape == (T, 4, 24, 24)
    assert (got == want).mean() >= 0.999


def test_run_all_passes_the_clip_checkpoint(outputs, tmp_path):
    """run_all's front branch hands front_detector, front_tracker, their
    checkpoints and front_clip to the stage: it runs the sam3 detector with
    the CLIP tower (its ``clip`` span is timed) at the stage's default 16
    object slots."""
    from skix_torch.pipelines.run_all import main as run_all

    root = outputs[1].parent
    cfg = _stage_cfg(root / "front_raw", None, root)
    run_all({"paths": {"pt_root": str(tmp_path), "work_root": str(tmp_path),
                       "video_root": str(root / "front_raw")},
             "stages": ["prepare_front_results"], "device": "cpu",
             "front_prompts": ["snow"], "front_detector": cfg["detector"],
             "front_detector_checkpoint": cfg["detector_checkpoint"],
             "front_tracker": cfg["tracker"],
             "front_tracker_checkpoint": cfg["tracker_checkpoint"],
             "front_clip": cfg["clip"]})
    front = tmp_path / "front"
    scores = np.load(front / "p01" / "snow_scores.npy")
    assert scores.shape == (T, 16) and np.isfinite(scores).all()
    spans = json.loads((front / "front_timing.json").read_text())
    assert spans["clip"]["count"] == 1
