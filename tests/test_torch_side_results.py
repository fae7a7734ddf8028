"""skix_torch's side-view stage against skix's, on the CPU at a tiny width.

One skix estimator (and its jitted clip forward) serves the whole file: the
CLI twin hands it to skix's stage in place of the one the stage would
build from the same checkpoint, which the port's stage reads. Outputs are
held at 1e-4 relative to each array's largest element where that exceeds
1 (2D keypoints in image pixels, cm-scale rig sums, focal lengths).
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_same_outputs, close_scaled, sam3d_body_pair

from skix.models import sam3d_body as S
from skix_torch.convert import flax_to_state_dict
from skix_torch.io.contracts import PTInfo, save_pt_info
from skix_torch.models import sam3d_body as P

rng = np.random.default_rng(7070)
# the stage's keys and the model they build (num_heads 6, as run_all's)
STAGE = dict(crop_size=32, patch_size=16, embed_dim=24, vit_depth=1,
             num_heads=6, decoder_depth=1, batch_size=2)
MODEL = dict(crop_size=32, patch_size=16, embed_dim=24, depth=1, num_heads=6,
             decoder_depth=1)
T, H, W = 5, 48, 64


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """skix's variables, its estimator (compiled once for the file) and
    their checkpoint npz."""
    from skix.pipelines.videopose3d import save_checkpoint

    smod, variables, _, _ = sam3d_body_pair(rng, **MODEL)
    path = tmp_path_factory.mktemp("ckpt") / "sam3d.npz"
    save_checkpoint(str(path), variables)
    return variables, S.SAM3DBodyEstimator(smod, variables), path


def _clip(seed):
    r = np.random.default_rng(seed)
    frames = r.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
    # boxes 20-40 px tall, one across the frame's top-left corner
    x0 = r.uniform(-10, 30, T)
    y0 = r.uniform(-10, 10, T)
    boxes = np.stack([x0, y0, x0 + r.uniform(15, 30, T),
                      y0 + r.uniform(20, 40, T)], -1).astype(np.float32)
    masks = (r.random((T, 1, H, W)) > 0.5).astype(np.uint8)
    return frames, boxes, masks


def _same_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            close_scaled(g[k], w[k], 1e-4)


def test_process_clip_full_with_focal_and_masks(weights):
    """``inference_type="full"`` (body, both hand passes, the body pass
    again with the refined hands), per-frame masks at score 1, a per-frame
    focal (the translation re-expressed under it), a padded last batch."""
    variables, est_s, _ = weights
    frames, boxes, masks = _clip(1)
    focal = np.linspace(900.0, 1100.0, T).astype(np.float32)
    kw = dict(batch_size=2, image_focal=focal, inference_type="full",
              masks=masks)
    want = est_s.process_clip(frames, boxes, **kw)
    est_p = P.SAM3DBodyEstimator(P.SAM3DBody(**MODEL),
                                 flax_to_state_dict(variables), device="cpu")
    got = est_p.process_clip(frames, boxes, **kw)
    _same_frames(got, want)
    np.testing.assert_array_equal([g["focal_length"] for g in got], focal)


def test_checkpoint_without_hand_branch_is_grafted(weights):
    """A body-only checkpoint keeps the port's seeded hand decoder and mask
    encoder (skix grafts its own); any other missing leaf raises."""
    variables, _, _ = weights
    sd = flax_to_state_dict(variables)
    body = {k: v for k, v in sd.items()
            if not k.startswith(("hand_init_tokens", "head_hand.",
                                 "mask_prompt."))}
    est = P.SAM3DBodyEstimator(P.SAM3DBody(**MODEL), body, device="cpu")
    torch.testing.assert_close(est.model.kv_proj.weight, sd["kv_proj.weight"])
    out = est.process_clip(*_clip(2)[:2], batch_size=2, inference_type="full")
    assert np.isfinite(out[0]["pred_keypoints_3d"]).all()
    del sd["kv_proj.weight"]
    with pytest.raises(KeyError, match="kv_proj.weight"):
        P.SAM3DBodyEstimator(P.SAM3DBody(**MODEL), sd, device="cpu")


def _write_records(root):
    """One person, three side-view records of the same size: person boxes
    and masks (``cam_left``), only detectron2 boxes (``cam_right``), no
    boxes (``cam_top``: one full-image crop per frame)."""
    pdir = root / "p01"
    for i, (name, keys) in enumerate((("cam_left", ("yolo_bbox",)),
                                      ("cam_right", ("d2_bbox",)),
                                      ("cam_top", ()))):
        frames, boxes, masks = _clip(10 + i)
        info = PTInfo(video_name=name, frame_count=T, img_shape=(H, W),
                      fps=30.0, duration=T / 30.0, frames=frames,
                      yolo_mask=masks)
        for k in keys:
            setattr(info, k, boxes)
        save_pt_info(pdir / f"{name}.npz", info)


def _stage_yaml(pt_root, out_root, ckpt, **extra):
    body = {"paths": {"pt_root": str(pt_root), "out_root": str(out_root)},
            "checkpoint": str(ckpt), "inference_type": "full",
            "use_mask": True, **STAGE, **extra}
    return "\n".join(f"{k}: {json.dumps(v)}" for k, v in body.items()) + "\n"


def test_cli_twin(weights, tmp_path, monkeypatch):
    """The same records and checkpoint through skix's and the port's
    ``prepare_side_results``: every npz field of every frame, and the
    summary; then a rerun skips the finished records (resume by existence)
    and writes an empty summary, as skix's does."""
    import skix.pipelines.prepare_side_results as skix_stage
    from skix_torch.pipelines import prepare_side_results as port_stage

    _, est_s, ckpt = weights
    monkeypatch.setattr(skix_stage, "build_estimator", lambda cfg: est_s)
    pt = tmp_path / "pt"
    _write_records(pt)
    outs = {}
    for side, fn in (("skix", skix_stage.main), ("port", port_stage.main)):
        cdir = tmp_path / f"cfg_{side}"
        cdir.mkdir()
        (cdir / "sam3d_body.yaml").write_text(
            _stage_yaml(pt, tmp_path / side, ckpt)
            + ("device: cpu\n" if side == "port" else ""))
        fn([f"--config-dir={cdir}"])
        outs[side] = tmp_path / side
    summary = json.loads((outs["port"] / "sam3d_summary.json").read_text())
    assert summary == {"p01/cam_left": T, "p01/cam_right": T, "p01/cam_top": T}
    assert_same_outputs(outs["skix"], outs["port"], atol=1e-4, scaled=True)
    before = sorted(p.stat().st_mtime_ns for p in outs["port"].rglob("*.npz"))
    port_stage.main([f"--config-dir={tmp_path / 'cfg_port'}"])
    assert json.loads((outs["port"] / "sam3d_summary.json").read_text()) == {}
    assert before == sorted(p.stat().st_mtime_ns
                            for p in outs["port"].rglob("*.npz"))


def test_cli_fov_feeds_the_vertical_focal(weights, tmp_path):
    """``fov_name: moge2`` with a MoGe checkpoint (a 4 × 4 grid; the
    frames' padded grid is 4 × 5, so its position table is resampled):
    each saved focal is the MoGe vertical focal of its stride's frame,
    repeated over the stride, and the fuse stage's loader reads the
    record's directory. (skix's stage is not run: the focal search on a
    random model's maps is ill-conditioned, ``test_torch_moge.py``.)"""
    import jax.numpy as jnp
    from _torch_parity import random_variables

    from skix.models.moge import MoGePointModel
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.io.contracts import load_pt_info
    from skix_torch.models.moge import MoGeFovEstimator
    from skix_torch.models.moge import MoGePointModel as PortMoGe
    from skix_torch.pipelines import prepare_side_results as port_stage
    from skix_torch.pipelines.fuse import load_sam3d_sequence

    _, _, ckpt = weights
    fov = dict(fov_patch_size=14, fov_embed_dim=32, fov_depth=2,
               fov_num_heads=2)
    smod = MoGePointModel(patch_size=14, embed_dim=32, depth=2, num_heads=2,
                          taps=(0, 0, 0, 1))
    mv = random_variables(smod, rng, jnp.zeros((1, 56, 56, 3)))
    save_checkpoint(str(tmp_path / "moge.npz"), mv)
    pt = tmp_path / "pt"
    _write_records(pt)
    for rec in ("cam_right", "cam_top"):
        (pt / "p01" / f"{rec}.npz").unlink()
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "sam3d_body.yaml").write_text(_stage_yaml(
        pt, tmp_path / "out", ckpt, fov_name="moge2",
        fov_checkpoint=str(tmp_path / "moge.npz"), fov_stride=2,
        device="cpu", **fov))
    port_stage.main([f"--config-dir={cdir}"])
    files = sorted((tmp_path / "out" / "p01" / "cam_left").glob("frame_*"))
    got = np.array([float(np.load(f)["focal_length"]) for f in files])
    est = MoGeFovEstimator(
        PortMoGe(patch_size=14, embed_dim=32, depth=2, num_heads=2,
                 taps=(0, 0, 0, 1)), flax_to_state_dict(tmp_path / "moge.npz"),
        device="cpu")
    frames = load_pt_info(pt / "p01" / "cam_left.npz").frames
    want = np.repeat(est.intrinsics_for_clip(frames[::2])[:, 1, 1], 2)[:T]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    k3, k2 = load_sam3d_sequence(tmp_path / "out" / "p01" / "cam_left")
    assert k3.shape == (T, 70, 3) and k2.shape == (T, 70, 2)


def test_unported_detector_and_unknown_names_raise():
    from skix_torch.pipelines import prepare_side_results as port_stage

    # vitdet is ported (tests/test_torch_side_detector.py): its name is
    # taken, and a torch checkpoint is refused with the converter's name
    with pytest.raises(ValueError, match="convert_detectron2_cascade"):
        port_stage.build_human_detector({"detector_name": "vitdet",
                                         "detector_checkpoint": "d2.pth"})
    with pytest.raises(ValueError, match="detector_name"):
        port_stage.build_human_detector({"detector_name": "yolo"})
    assert port_stage.build_human_detector({"detector_name": None}) is None
    with pytest.raises(ValueError, match="fov_name"):
        port_stage.build_fov_estimator({"fov_name": "depthpro"})
    assert port_stage.build_fov_estimator({"fov_name": None}) is None
