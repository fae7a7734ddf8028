"""skix_torch's prepare_dataset stage against skix's, on the CPU: the same
videos and the same checkpoints give the same records.

- The ``skix`` backend with the compact detector, the depth task (a DPT of
  skix's test width through the attention path), the flow task (RAFT at
  skix's CLI-test width) and ByteTrack in its ``botsort`` mode (camera
  motion fitted on the flow): one person, two 6-frame 64 × 64 videos, the
  weights from npz checkpoints that both sides load.
- The ``precomputed`` backend, and run_all with ``stages:
  [prepare_dataset, videopose3d]`` on sidecar detections with one lifter
  checkpoint.
- The mask slot (selection on the seg boxes, jax's bilinear upsample, the
  0.5 threshold), on synthetic seg detections.
- skix's stage hands a torch checkpoint to the lifter's loader (a
  ``KeyError`` its per-video guard swallows); the port names the
  converter.

Records are compared array by array within 1e-4, relative to an array's
largest element where that exceeds 1 (pixels), picks and ids equal.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_same_outputs, port_variables

T, H, W = 6, 64, 64
rng = np.random.default_rng(4321)


def _save_npz(path, variables):
    from skix_torch.convert import flatten_tree

    np.savez(path, **flatten_tree(variables))


def _videos(root, n=2, sidecars=False):
    from skix_torch.io.video import write_video

    person = root / "p01"
    person.mkdir(parents=True)
    base = rng.integers(0, 255, (T + 8, H + 16, W + 16, 3)).astype(np.uint8)
    for i in range(n):
        # a drifting crop of one texture: the flow has something to follow
        frames = np.stack([base[t + i, 2 * t:2 * t + H, t:t + W]
                           for t in range(T)])
        write_video(person / f"osmo_{i + 1}.mp4", frames, fps=10)
        if sidecars:
            # 4 slots, as the compact detector's top_k: skix's jitted
            # selection is compiled once for the file
            boxes = np.zeros((T, 4, 4), np.float32)
            kpts = np.zeros((T, 4, 17, 3), np.float32)
            valid = np.zeros((T, 4), bool)
            for t in range(T):
                boxes[t, 0] = [24 + t, 30, 12, 30]
                boxes[t, 2] = [40, 20 + t, 10, 18]
                kpts[t, 0, :, :2] = rng.uniform(10, 50, (17, 2))
                kpts[t, 2, :, :2] = rng.uniform(10, 50, (17, 2))
                kpts[t, :, :, 2] = rng.uniform(0.3, 1.0, (4, 17))
                valid[t, [0, 2]] = True
            valid[2] = False
            np.savez(person / f"osmo_{i + 1}.detections.npz", boxes=boxes,
                     keypoints=kpts, det_valid=valid)


SKIX_CFG = """paths:
  video_root: {videos}
  out_root: {out}
backend: skix
pose_model: compact
tasks: [pose, depth, optical_flow]
detector_width: 16
detector_depth: 1
detector_checkpoint: {ckpt}/detector.npz
top_k: 4
score_threshold: 0.45
det_batch: 4
depth_dim: 32
depth_layers: 4
depth_heads: 2
depth_features: 16
depth_batch: 4
depth_checkpoint: {ckpt}/depth.npz
flow_hidden: 32
flow_context: 32
flow_iters: 2
flow_checkpoint: {ckpt}/flow.npz
tracking: true
bytetrack:
  tracker_type: botsort
  max_tracks: 8
chunk_size: 4
store_frames: false
"""


@pytest.fixture(scope="module")
def skix_backend_records(tmp_path_factory):
    from skix.pipelines.prepare_dataset import main as skix_main
    from skix_torch.models.dpt import MonocularDepth
    from skix_torch.models.pose_detector import PoseDetector
    from skix_torch.models.raft import RAFT
    from skix_torch.pipelines.prepare_dataset import main as port_main

    tmp = tmp_path_factory.mktemp("prep")
    _videos(tmp / "videos")
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    _save_npz(ckpt / "detector.npz", port_variables(
        PoseDetector(width=16, depth=1), seed=1))
    _save_npz(ckpt / "depth.npz", port_variables(MonocularDepth(
        patch_size=16, embed_dim=32, depth=4, num_heads=2, taps=(0, 1, 2, 3),
        features=16, image_hw=(H, W)), seed=2))
    _save_npz(ckpt / "flow.npz", port_variables(RAFT(
        hidden=32, context=32, corr_levels=3, corr_radius=3, iters=2),
        seed=3))
    body = SKIX_CFG.format(videos=tmp / "videos", out="{out}", ckpt=ckpt)
    outs = {}
    for side, fn in (("skix", skix_main), ("port", port_main)):
        cdir = tmp / f"cfg_{side}"
        cdir.mkdir()
        (cdir / "prepare_dataset.yaml").write_text(
            body.format(out=tmp / side) + "device: cpu\n")
        fn([f"--config-dir={cdir}"])
        outs[side] = tmp / side
    return outs["skix"], outs["port"]


def test_skix_backend_records_equal_skix(skix_backend_records):
    from skix_torch.io.contracts import load_pt_info

    want, got = skix_backend_records
    assert_same_outputs(want, got, atol=1e-4, scaled=True)
    for i in (1, 2):
        rec = load_pt_info(got / "p01" / f"osmo_{i}.npz")
        assert rec.depth.shape == (T, 1, H, W)
        assert rec.optical_flow.shape == (T - 1, 2, H, W)
        assert np.abs(rec.optical_flow).max() > 1e-3
        assert rec.yolo_keypoints.shape == (T, 17, 3)
        assert np.isfinite(rec.yolo_keypoints).all()


def test_stage_track_ids_match_skix():
    """The stage's tracking step (box conversion, the flow subsampled for
    botsort's camera motion, the tracker) on the same detections."""
    from skix.pipelines.prepare_dataset import \
        _compute_track_ids as skix_ids
    from skix_torch.pipelines.prepare_dataset import \
        _compute_track_ids as port_ids

    boxes = np.abs(rng.normal(size=(T, 4, 4))).astype(np.float32) * 20 + 5
    scores = rng.uniform(0.2, 0.9, (T, 4)).astype(np.float32)
    valid = rng.random((T, 4)) < 0.8
    flow = rng.normal(size=(T - 1, 2, H, W)).astype(np.float32)
    for mode in ("bytetrack", "botsort"):
        cfg = {"bytetrack": {"tracker_type": mode, "max_tracks": 8}}
        want = skix_ids(cfg, boxes, scores, valid, flow=flow)
        got = port_ids(cfg, boxes, scores, valid, flow=flow, device="cpu")
        np.testing.assert_array_equal(got, want)


def test_mask_slot_matches_skix():
    from skix.pipelines.prepare_dataset import \
        _assemble_person_mask as skix_mask
    from skix_torch.pipelines.prepare_dataset import \
        _assemble_person_mask as port_mask

    Hf, Wf = 60, 70                       # padded to 64 × 96, grid 16 × 24
    boxes = np.abs(rng.normal(size=(T, 3, 4))).astype(np.float32) * 20 + 4
    det = {"seg_boxes": boxes,
           "seg_valid": rng.random((T, 3)) < 0.7,
           "seg_masks": rng.random((T, 3, 16, 24)).astype(np.float32)}
    det["seg_valid"][1] = False
    want = skix_mask(det, Hf, Wf)
    got = port_mask(det, Hf, Wf, device="cpu")
    assert got.shape == want.shape == (T, 1, Hf, Wf) and got.dtype == np.uint8
    # near 0.5 a pixel may flip between two roundings of the upsample
    assert (got == want).mean() > 0.999


def test_precomputed_backend_and_run_all_match_skix(tmp_path):
    """run_all's first stage on sidecar detections, then the lifter: the
    records and the lifted keypoints equal skix's."""
    import yaml

    from skix.pipelines.run_all import main as skix_run_all
    from skix_torch.models.videopose3d import TemporalLifter
    from skix_torch.pipelines.run_all import main as port_run_all

    _videos(tmp_path / "videos", sidecars=True)
    _save_npz(tmp_path / "lifter.npz", port_variables(
        TemporalLifter(filter_widths=(3, 3), channels=32), seed=4))

    def cfg(side):
        return {"paths": {"video_root": str(tmp_path / "videos"),
                          "pt_root": str(tmp_path / side / "pt"),
                          "work_root": str(tmp_path / side / "work")},
                "stages": ["prepare_dataset", "videopose3d"],
                "backend": "precomputed", "store_frames": True,
                "lifter_checkpoint": str(tmp_path / "lifter.npz"),
                "filter_widths": [3, 3], "channels": 32,
                "kpt_source": "detectron2", "device": "cpu"}

    cdir = tmp_path / "configs"
    cdir.mkdir()
    (cdir / "run_all.yaml").write_text(yaml.safe_dump(cfg("skix")))
    skix_run_all([f"--config-dir={cdir}"])
    port_run_all(cfg("port"))
    want, got = tmp_path / "skix", tmp_path / "port"
    assert_same_outputs(want / "pt", got / "pt", atol=1e-5, scaled=True)
    assert_same_outputs(want / "work" / "videopose3d",
                        got / "work" / "videopose3d", atol=1e-4, scaled=True)
    assert sorted(p.name for p in (got / "work" / "videopose3d" / "p01")
                  .glob("*.npy"))


def test_torch_checkpoint_fault(tmp_path, caplog):
    """skix's stage loads every model's checkpoint through the lifter's
    loader: a torch ``yolo_checkpoint`` fails there (``KeyError``, caught
    by the per-video guard, no record). The port refuses it with a
    ``ValueError`` that names the converter to run."""
    from skix.pipelines.prepare_dataset import main as skix_main
    from skix_torch.pipelines.prepare_dataset import (load_variables,
                                                      main as port_main)

    _videos(tmp_path / "videos", n=1)
    pt = tmp_path / "yolo11s-pose.pt"
    torch.save({"model.0.conv.weight": torch.zeros(16, 3, 3, 3)}, pt)
    cfg = {"paths": {"video_root": str(tmp_path / "videos"),
                     "out_root": str(tmp_path / "skix")},
           "backend": "skix", "pose_model": "yolo", "yolo_scale": "n",
           "yolo_checkpoint": str(pt), "tracking": False}
    cdir = tmp_path / "configs"
    cdir.mkdir()
    import yaml

    (cdir / "prepare_dataset.yaml").write_text(yaml.safe_dump(cfg))
    with caplog.at_level("ERROR"):
        skix_main([f"--config-dir={cdir}"])
    assert not (tmp_path / "skix" / "p01" / "osmo_1.npz").exists()
    assert "KeyError" in caplog.text
    with pytest.raises(ValueError, match="convert_ultralytics_pose"):
        load_variables(cfg, "yolo_checkpoint")
    caplog.clear()
    with caplog.at_level("ERROR"):
        port_main(dict(cfg, paths={"video_root": str(tmp_path / "videos"),
                                   "out_root": str(tmp_path / "port")},
                       device="cpu"))
    assert not (tmp_path / "port" / "p01" / "osmo_1.npz").exists()
    assert "convert_ultralytics_pose" in caplog.text
