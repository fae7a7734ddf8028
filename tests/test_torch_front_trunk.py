"""skix_torch's memory tracker with the ViT-Det trunk, and the front stage
with it and its overlay video, against skix's, on the CPU.

The trunk at a tiny width (64 wide, 8 blocks: block 7 global, the others
in 24 × 24 windows over the 8 × 8 grid of a 112 px frame, 16 heads as the
tracker fixes them), under the tiny memory tracker of
``tests/test_torch_front_results.py``; random flax variables saved as skix
checkpoints and read by both stages. The stage runs with ``tracker:
{trunk: vitdet, ...}`` and ``overlay_video: true`` through skix's and the
port's CLI on the same video.

Tolerances as in ``tests/test_torch_front_results.py``: the slot lifecycle
exact, scores to 1e-5, boxes to one pixel of the 8 × 8 tracker grid scaled
to the frame (a logit within rounding of 0 may flip its pixel), masks
pixel by pixel in at least 99.9 % of pixels; the overlay videos hold every
frame; the trunk's features and one tracker step within 1e-4 (relative to
the largest element where that exceeds 1).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0, random_variables

T, H, W = 4, 48, 64
PROMPTS = ("person", "snow")
TRACKER = dict(features=16, num_heads=2, mem_slots=3, trunk="vitdet",
               vit_embed_dim=64, vit_depth=8)
TINY = dict(img_size=112, patch_size=14, backbone_dim=64, backbone_depth=2,
            backbone_heads=2, mlp_ratio=4.0, window_size=4,
            global_att_blocks=[1], d_model=64, num_queries=12,
            encoder_layers=2, decoder_layers=2)


@pytest.fixture(scope="module")
def tracker_vars():
    from skix.tracking.memory_tracker import MaskMemoryTracker, init_memory

    trk = MaskMemoryTracker(**TRACKER)
    v = random_variables(trk, np.random.default_rng(9),
                         jnp.zeros((1, 112, 112, 3)),
                         init_memory(3, 8, 8, 16), method=trk.step)
    return trk, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       v)


def test_vitdet_trunk_tracker_matches_skix(tracker_vars):
    """The trunk's features of a frame, and a step (memory attention,
    decode, memory write) on a bank holding one written memory."""
    from skix.tracking.memory_tracker import init_memory
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.tracking import memory_tracker as M

    trk, v = tracker_vars
    model = M.MaskMemoryTracker(**TRACKER).eval()
    assert not load_into(model, flax_to_state_dict(v))
    x = np.random.default_rng(10).random((1, 112, 112, 3)).astype(np.float32)
    bank = init_memory(3, 8, 8, 16)
    mem = np.random.default_rng(11).normal(size=(8, 8, 16)).astype(
        np.float32)
    bank = bank._replace(mem=bank.mem.at[0].set(mem),
                         valid=bank.valid.at[0].set(True))
    # one compiled program for both
    want, (wm, ws, wb) = jit0(lambda vv, im, b: (
        trk.apply(vv, im, method=trk.encode_frame),
        trk.apply(vv, im, b, method=trk.step)))(v, x, bank)
    with torch.no_grad():
        got = model.encode_frame(torch.as_tensor(x))
    assert got.shape == (1, 8, 8, 16)
    assert model.encoder.feature_hw(112, 112) == (8, 8)
    close_scaled(got.numpy(), np.asarray(want), 1e-4)

    pb = M.init_memory(3, 8, 8, 16)
    pb = M.write_conditioning(pb, torch.as_tensor(mem)[None])
    with torch.no_grad():
        gm, gs, gb = model.step_from_feats(got, pb)
    close_scaled(gm.numpy(), np.asarray(wm), 1e-4)
    close_scaled(gs.numpy(), np.asarray(ws), 1e-4)
    close_scaled(gb.mem[0].numpy(), np.asarray(wb.mem), 1e-4)


def test_trunk_converter_loads_a_reference_trunk():
    """A reference ViT-Det state dict (``patch_embed.proj``, a cls entry
    on ``pos_embed``, ``ln_pre``, ``blocks.{i}``) lands on every trunk
    parameter of the tracker."""
    from skix_torch.tracking import memory_tracker as M

    model = M.MaskMemoryTracker(**TRACKER)
    trunk = {k[len("encoder.vitdet."):]: v
             for k, v in model.state_dict().items()
             if k.startswith("encoder.vitdet.")}
    rng = np.random.default_rng(12)
    ref = {}
    for k, v in trunk.items():
        name = k.replace("block_", "blocks.")
        shape = tuple(v.shape)
        if k == "pos_embed":
            shape = (1, 1 + shape[1] * shape[2], shape[3])
        ref[name] = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    sd = M.convert_tracker_trunk(ref)
    assert set(sd) == {f"encoder.vitdet.{k}" for k in trunk}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(not k.startswith("encoder.vitdet.")
                                  for k in missing)
    np.testing.assert_array_equal(
        model.encoder.vitdet.pos_embed.detach().numpy().reshape(-1),
        ref["pos_embed"][0, 1:].numpy().reshape(-1))


def _stage_cfg(vid_root, out_root, ckpts):
    return {"paths": {"video_root": str(vid_root), "out_root": str(out_root)},
            "model": "sam3", "prompts": list(PROMPTS), "detector": TINY,
            "detector_checkpoint": str(ckpts / "det.npz"),
            "tracker": TRACKER,
            "tracker_checkpoint": str(ckpts / "trk.npz"),
            "clip": {"checkpoint": None}, "max_objects": 4, "max_dets": 6,
            "det_score_threshold": 0.0, "new_det_thresh": 0.0,
            "save_mask_size": 24, "max_frames": None,
            "overlay_video": True, "overlay_fps": 5.0}


def test_front_stage_with_the_trunk_and_overlay_matches_skix(tracker_vars,
                                                             tmp_path):
    import cv2
    import yaml

    from skix.io.video import write_video
    from skix.pipelines.prepare_front_results import main as skix_main
    from skix.pipelines.videopose3d import save_checkpoint
    from skix.tracking.sam3_detector import Sam3Detector
    from skix_torch.pipelines.prepare_front_results import main as torch_main

    _, trk_v = tracker_vars
    rng = np.random.default_rng(0)
    write_video(tmp_path / "front_raw" / "p01" / "clip.mp4",
                rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8), fps=10)
    det_v = random_variables(Sam3Detector.tiny(), rng,
                             jnp.zeros((1, 112, 112, 3)),
                             jnp.zeros((1, 4, 64)))
    save_checkpoint(str(tmp_path / "det.npz"), det_v)
    save_checkpoint(str(tmp_path / "trk.npz"), trk_v)
    outs = {}
    for side, fn in (("skix", skix_main), ("port", torch_main)):
        cdir = tmp_path / f"cfg_{side}"
        cdir.mkdir()
        cfg = dict(_stage_cfg(tmp_path / "front_raw", tmp_path / side,
                              tmp_path),
                   **({"device": "cpu"} if side == "port" else {}))
        (cdir / "prepare_front_results.yaml").write_text(yaml.safe_dump(cfg))
        fn([f"--config-dir={cdir}"])
        outs[side] = tmp_path / side / "p01"
    names = sorted(p.name for p in outs["port"].iterdir())
    assert names == sorted(p.name for p in outs["skix"].iterdir())
    assert "person_overlay.mp4" in names and "snow_overlay.mp4" in names
    load = lambda side, name: np.load(outs[side] / name)  # noqa: E731
    for prompt in PROMPTS:
        for kind in ("active", "obj_ids"):
            np.testing.assert_array_equal(load("port", f"{prompt}_{kind}.npy"),
                                          load("skix", f"{prompt}_{kind}.npy"))
        for kind in ("scores", "tracker_scores"):
            np.testing.assert_allclose(load("port", f"{prompt}_{kind}.npy"),
                                       load("skix", f"{prompt}_{kind}.npy"),
                                       atol=1e-5, rtol=0)
        np.testing.assert_allclose(load("port", f"{prompt}_bboxes.npy"),
                                   load("skix", f"{prompt}_bboxes.npy"),
                                   atol=W / 8 + 1e-3, rtol=0)
        got, want = (load(s, f"{prompt}_masks.npy") for s in ("port", "skix"))
        assert got.shape == want.shape == (T, 4, 24, 24)
        assert (got == want).mean() >= 0.999
        for side in ("port", "skix"):
            cap = cv2.VideoCapture(str(outs[side] / f"{prompt}_overlay.mp4"))
            assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == T
            assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(5.0)
            cap.release()
    assert (json.loads((tmp_path / "port" / "front_summary.json").read_text())
            == json.loads((tmp_path / "skix"
                           / "front_summary.json").read_text()))
