"""skix_torch's side stage with the human detector in the loop against
skix's, on the CPU: ``prepare_side_results`` with ``detector_name: vitdet``
on a record stored without person boxes, through both CLIs.

The cascade is the tiny trunk of skix's tests (embed 32, depth 2, heads 2,
window 2, one global block, 64 px) under the heads the stage builds, the
estimator the side stage's tiny one; both are seeded, saved as skix
checkpoints and read by the port's stage (the cascade's person logits
lifted so that boxes pass the thresholds). skix's stage gets skix's
``HumanDetector`` (its resize, padding, scaling, post-processing and
person slots) around the port's network with the same weights, and its
estimator compiled once: the network against skix's is
``tests/test_torch_cascade_rcnn.py`` (raw heads and detections), which
leaves this file the stage and the detector's code around the network,
without a second compile of skix's cascade. Each stage runs once; the
tests read what each detector returned a batch (``detect_frames``, the
batch padded), the person slots of each frame (``detect_clip``) and the
written files.

Tolerances: 1e-4 in float32, relative to an array's largest element where
that exceeds 1 (boxes in pixels); classes, validity, the slots, their
lexsort order and ``det_valid`` equal. The frames are video-like (smooth):
the two sides' boxes agree to about 1e-5 of the frame, not exactly (each
side resizes the frames its own way), and on per-pixel noise a crop that
moves with its box changes by the whole intensity range a pixel, which
the random estimator amplifies past 1e-4.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import (assert_same_outputs, close_scaled, port_variables,
                           sam3d_body_pair)

from skix.models import cascade_rcnn as S
from skix_torch.models import cascade_rcnn as P

KW = dict(embed_dim=32, depth=2, num_heads=2, window_size=2,
          global_indexes=(1,))
SIZE, BATCH, T = 64, 3, 2

SIDE = dict(crop_size=32, patch_size=16, embed_dim=24, vit_depth=1,
            num_heads=6, decoder_depth=1, batch_size=2)
SIDE_MODEL = dict(crop_size=32, patch_size=16, embed_dim=24, depth=1,
                  num_heads=6, decoder_depth=1)
DETECTOR = dict(detector_name="vitdet", detector_embed_dim=32,
                detector_depth=2, detector_num_heads=2, detector_window=2,
                detector_global_indexes=[1], detector_image_size=SIZE,
                detector_batch=BATCH, detector_bbox_thr=0.3, max_people=3)


def _smooth_frames(seed, H, W):
    """Video-like frames: a coarse random grid upsampled smoothly. The two
    detectors' boxes agree to about 1e-5 of the frame, not exactly; each
    crop moves with its box by the image's gradient, which per-pixel noise
    makes as large as the whole intensity range, and the random estimator
    amplifies such a crop difference past 1e-4."""
    import cv2

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 255, (T, 5, 7, 3)).astype(np.float32)
    return np.stack([np.clip(cv2.resize(c, (W, H),
                                        interpolation=cv2.INTER_CUBIC),
                             0, 255).astype(np.uint8) for c in coarse])


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Both stages once, through their CLIs, on one 2-frame record of
    40 × 56 (a batch of 3, padded) from the same checkpoints:
    per side the detector's outputs a batch (``detect_frames``), the person
    slots (``detect_clip``) and the output root."""
    import skix.pipelines.prepare_side_results as skix_stage
    from skix.models.sam3d_body import SAM3DBodyEstimator
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.io.contracts import PTInfo, save_pt_info
    from skix_torch.pipelines import prepare_side_results as port_stage

    with torch.device("meta"):
        model = P.CascadeMaskRCNN(**KW, image_size=SIZE)
    model = model.to_empty(device="cpu").eval()
    variables = port_variables(model, 11)
    for k in range(3):
        variables["params"][f"box_head{k}"]["cls_score"]["bias"][0] += 4.5
        with torch.no_grad():
            getattr(model, f"box_head{k}").cls_score.bias[0] += 4.5

    def network(_, x):
        """The port's network on skix's resized, padded batch."""
        return S.CascadeDetections(*(jnp.asarray(t.numpy()) for t in model(
            torch.as_tensor(np.array(x)))))

    root = tmp_path_factory.mktemp("side_det")
    save_checkpoint(str(root / "det.npz"), variables)
    est_mod, est_vars, _, _ = sam3d_body_pair(np.random.default_rng(7),
                                              **SIDE_MODEL)
    save_checkpoint(str(root / "sam3d.npz"), est_vars)
    seen = {"skix": {"frames": []}, "port": {"frames": []}}

    def record(side, det):
        frames, clip = det.detect_frames, det.detect_clip

        def detect_frames(*a, **k):
            seen[side]["frames"].append(frames(*a, **k))
            return seen[side]["frames"][-1]

        def detect_clip(*a, **k):
            seen[side]["slots"] = clip(*a, **k)
            return seen[side]["slots"]
        det.detect_frames, det.detect_clip = detect_frames, detect_clip
        return det

    def skix_detector(cfg):
        det = S.HumanDetector.__new__(S.HumanDetector)
        det.model, det.variables, det.image_size = None, variables, SIZE
        det._fwd = network
        return record("skix", det)

    build = port_stage.build_human_detector
    patch = pytest.MonkeyPatch()
    patch.setattr(skix_stage, "build_estimator",
                  lambda cfg: SAM3DBodyEstimator(est_mod, est_vars))
    patch.setattr(skix_stage, "build_human_detector", skix_detector)
    patch.setattr(port_stage, "build_human_detector",
                  lambda cfg, device=None: record("port", build(cfg, device)))
    save_pt_info(root / "pt" / "p01" / "cam_left.npz", PTInfo(
        video_name="cam_left", frame_count=T, img_shape=(40, 56), fps=30.0,
        duration=T / 30.0, frames=_smooth_frames(8, 40, 56)))
    try:
        for side, fn in (("skix", skix_stage.main),
                         ("port", port_stage.main)):
            cdir = root / f"cfg_{side}"
            cdir.mkdir()
            body = {"paths": {"pt_root": str(root / "pt"),
                              "out_root": str(root / side)},
                    "checkpoint": str(root / "sam3d.npz"),
                    "detector_checkpoint": str(root / "det.npz"),
                    **SIDE, **DETECTOR,
                    **({"device": "cpu"} if side == "port" else {})}
            (cdir / "sam3d_body.yaml").write_text("\n".join(
                f"{k}: {json.dumps(v)}" for k, v in body.items()) + "\n")
            fn([f"--config-dir={cdir}"])
            seen[side]["out"] = root / side
    finally:
        patch.undo()
    return seen["port"], seen["skix"], root / "det.npz"


def test_detections_match_skix(stage):
    """Each batch's detection slots as each detector returns them (each
    side's resize, padding and scaling back to the record's pixels; the
    padded last batch too): classes and validity equal, some valid;
    boxes, scores and masks within 1e-4."""
    got, want, _ = stage
    assert len(got["frames"]) == len(want["frames"]) == -(-T // BATCH)
    for g, w in zip(got["frames"], want["frames"]):
        for name in ("classes", "valid"):
            np.testing.assert_array_equal(getattr(g, name),
                                          np.asarray(getattr(w, name)))
        for name in ("boxes_xyxy", "scores", "masks"):
            close_scaled(getattr(g, name), np.asarray(getattr(w, name)),
                         1e-4)
    assert np.asarray(want["frames"][0].valid).any()


def test_detect_clip_slots_match_skix(stage):
    """The person slots of every frame: validity (some valid, at most
    ``max_people``) and lexsort order equal, boxes within 1e-4 of the
    frame."""
    (gb, gv), (wb, wv) = stage[0]["slots"], stage[1]["slots"]
    assert gv.shape == (T, 3) and gv.any()
    np.testing.assert_array_equal(gv, wv)
    close_scaled(gb, wb, 1e-4)


def test_side_stage_with_the_detector_matches_skix(stage):
    """Every npz field of every frame (the picked athlete's estimate and
    ``det_valid``) and the summary."""
    got, want, _ = stage
    assert json.loads((got["out"] / "sam3d_summary.json").read_text()) == {
        "p01/cam_left": T}
    with np.load(got["out"] / "p01" / "cam_left"
                 / "frame_000000_sam_3d_body_outputs.npz") as z:
        assert "det_valid" in z.files
    assert_same_outputs(want["out"], got["out"], atol=1e-4, scaled=True)


def test_detector_keys_and_checkpoints(stage):
    """The keys build the configured cascade with the checkpoint's
    weights; ``null`` disables it; a torch checkpoint is refused with the
    converter's name; other names raise."""
    from skix_torch.pipelines import prepare_side_results as port_stage

    det_ckpt = stage[2]
    det = port_stage.build_human_detector(
        {**DETECTOR, "device": "cpu", "detector_checkpoint": str(det_ckpt)})
    assert isinstance(det, P.HumanDetector) and det.image_size == SIZE
    assert det.model.net.block1.window_size == 0
    assert det.model.net.block0.attn.rel_pos_h.shape == (3, 16)
    assert port_stage.build_human_detector({"detector_name": None}) is None
    with pytest.raises(ValueError, match="convert_detectron2_cascade"):
        port_stage.build_human_detector({**DETECTOR, "device": "cpu",
                                         "detector_checkpoint": "d2.pth"})
    with pytest.raises(ValueError, match="detector_name"):
        port_stage.build_human_detector({"detector_name": "yolo"})
