"""Twin of ``tests/test_pipelines.py::TestPrepareFrontResults::
test_sam3_masklet_cli`` with ``overlay_video: false``: skix and skix_torch
run the ``prepare_front_results`` stage on the same video with the same
checkpoints (random flax variables of the tiny Sam3Detector and the
tracker, saved as skix checkpoint npz files), and write the same files.

Tolerances. Random weights with ``det_score_threshold 0.0`` spawn every
slot, and scores, boxes and masks come from thresholded float32 logits
that the two packages sum in other orders (about 1e-6 apart): the slot
lifecycle (``active``, ``obj_ids``) must agree exactly, the scores to
1e-5, the boxes to one mask pixel of the tracker grid scaled to the frame
(a logit within rounding of 0 may flip its pixel), and the bool masks
pixel by pixel in at least 99.9 % of pixels.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp
from _torch_parity import random_variables

T, H, W = 4, 48, 64
PROMPTS = ("person", "snow")
TRACKER = dict(features=16, num_heads=2, mem_slots=3)
TINY = dict(img_size=112, patch_size=14, backbone_dim=64, backbone_depth=2,
            backbone_heads=2, mlp_ratio=4.0, window_size=4,
            global_att_blocks=[1], d_model=64, num_queries=12,
            encoder_layers=2, decoder_layers=2)


def _stage_cfg(vid_root, out_root, ckpts):
    return {"paths": {"video_root": str(vid_root), "out_root": str(out_root)},
            "model": "sam3", "prompts": list(PROMPTS), "detector": TINY,
            "detector_checkpoint": str(ckpts / "det.npz"),
            "tracker": TRACKER,
            "tracker_checkpoint": str(ckpts / "trk.npz"),
            "clip": {"checkpoint": None}, "max_objects": 4, "max_dets": 6,
            "det_score_threshold": 0.0, "new_det_thresh": 0.0,
            "save_mask_size": 24, "max_frames": None,
            "overlay_video": False}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    from skix.io.video import write_video
    from skix.pipelines.prepare_front_results import main as skix_main
    from skix.pipelines.videopose3d import save_checkpoint
    from skix.tracking.memory_tracker import MaskMemoryTracker, init_memory
    from skix.tracking.sam3_detector import Sam3Detector
    from skix_torch.config import config_from_mapping
    from skix_torch.pipelines.prepare_front_results import main as torch_main

    root = tmp_path_factory.mktemp("front_twin")
    rng = np.random.default_rng(0)
    vid_root = root / "front_raw"
    (vid_root / "p01").mkdir(parents=True)
    write_video(vid_root / "p01" / "clip.mp4",
                rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8), fps=10)

    det = Sam3Detector.tiny()
    det_v = random_variables(det, rng, jnp.zeros((1, 112, 112, 3)),
                             jnp.zeros((1, 4, 64)))
    trk = MaskMemoryTracker(**TRACKER)
    trk_v = random_variables(trk, rng, jnp.zeros((1, 112, 112, 3)),
                             init_memory(3, 14, 14, 16), method=trk.step)
    save_checkpoint(str(root / "det.npz"), det_v)
    save_checkpoint(str(root / "trk.npz"), trk_v)

    skix_cfg = _stage_cfg(vid_root, root / "skix_out", root)
    cdir = root / "cfg"
    cdir.mkdir()
    import yaml

    (cdir / "prepare_front_results.yaml").write_text(yaml.safe_dump(skix_cfg))
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
    assert got == want
    s = json.loads((skix_out / "front_summary.json").read_text())
    t = json.loads((torch_out / "front_summary.json").read_text())
    assert t == s
    assert (torch_out / "front_timing.json").exists()


@pytest.mark.parametrize("prompt", PROMPTS)
def test_lifecycle_exact(outputs, prompt):
    skix_out, torch_out = outputs
    for kind in ("active", "obj_ids"):
        got, want = (_load(o, f"{prompt}_{kind}.npy") for o in outputs)
        assert got.shape == want.shape == (T, 4)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_scores_close(outputs, prompt):
    for kind in ("scores", "tracker_scores"):
        got, want = (_load(o, f"{prompt}_{kind}.npy") for o in outputs)
        assert got.shape == want.shape == (T, 4)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_boxes_and_masks_agree(outputs, prompt):
    # skix's person_bboxes.npy (T, 4) track path overwrites the (T, K, 4)
    # per-slot boxes of the "person" prompt, which share its name
    got, want = (_load(o, f"{prompt}_bboxes.npy") for o in outputs)
    assert got.shape == want.shape == ((T, 4) if prompt == "person"
                                       else (T, 4, 4))
    # one pixel of the 14×14 tracker grid, in frame pixels
    np.testing.assert_allclose(got, want, atol=W / 14 + 1e-3, rtol=0)
    got, want = (_load(o, f"{prompt}_masks.npy") for o in outputs)
    assert got.shape == want.shape == (T, 4, 24, 24)
    assert got.dtype == want.dtype == bool
    assert (got == want).mean() >= 0.999


def test_person_track_path(outputs):
    got, want = (_load(o, "person_bboxes.npy") for o in outputs)
    assert got.shape == want.shape == (T, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=W / 14 + 1e-3, rtol=0)
    np.testing.assert_array_equal(*(_load(o, "person_valid.npy")
                                    for o in outputs))


def test_overlay_video_refused(outputs, tmp_path):
    """``overlay_video: true`` is ported (no longer refused): the same run
    also writes each prompt's overlay video, one frame a video frame,
    and its other files equal the run without it."""
    import cv2

    from skix_torch.config import config_from_mapping
    from skix_torch.pipelines.prepare_front_results import main as torch_main

    skix_out, torch_out = outputs
    root = skix_out.parent
    torch_main(config_from_mapping(dict(
        _stage_cfg(root / "front_raw", tmp_path / "o", root),
        overlay_video=True, device="cpu")))
    out = tmp_path / "o" / "p01"
    for prompt in PROMPTS:
        cap = cv2.VideoCapture(str(out / f"{prompt}_overlay.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == T
        cap.release()
        np.testing.assert_array_equal(
            np.load(out / f"{prompt}_obj_ids.npy"),
            _load(torch_out, f"{prompt}_obj_ids.npy"))


@pytest.mark.parametrize("paths,ran", [
    ({"front_root": "given"}, False),        # front results supplied
    ({"video_root": "missing"}, False),      # no videos
])
def test_run_all_front_stage_skips_as_skix(tmp_path, paths, ran):
    """run_all's prepare_front_results branch skips where skix's does
    (front_root given, or no video root) and never runs the stage then."""
    from skix_torch.pipelines.run_all import PORTED_STAGES
    from skix_torch.pipelines.run_all import main as run_all

    assert "prepare_front_results" in PORTED_STAGES
    work = tmp_path / "work"
    run_all({"paths": {"pt_root": str(tmp_path), "work_root": str(work),
                       **{k: str(tmp_path / v) for k, v in paths.items()}},
             "stages": ["prepare_front_results"], "device": "cpu"})
    summary = json.loads((work / "pipeline_summary.json").read_text())
    assert ("prepare_front_results" in summary) is ran
    assert not (work / "front").exists()
