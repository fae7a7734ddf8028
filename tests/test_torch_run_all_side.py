"""run_all's side branch, skix against skix_torch on the CPU: the sam3d_body
stage (``paths.sam3d_root`` unset, so it writes ``work/sam3d``) and fuse,
which reads that output, from the same records and the same tiny SAM3DBody
checkpoint at run_all's keys (crop, embed, depth, batch, and inference
type ``body``, not the default, so that the key is seen to pass; the
``full`` path is held in ``test_torch_side_results.py``; the stage's 6
heads and decoder depth 4). Every side-view npz field within
1e-4 relative to its largest element where that exceeds 1 (pixels,
focal), the fused joints equal to skix's within 1e-4 m (their mean
distance, the fused MPJPE of one against the other, too).
"""

import numpy as np
import pytest

from _torch_parity import assert_same_outputs, sam3d_body_pair

T, H, W = 6, 40, 56
SIZE = dict(sam3d_crop_size=32, sam3d_embed_dim=24, sam3d_depth=1,
            sam3d_batch_size=4, sam3d_inference_type="body")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import yaml

    from skix.pipelines.run_all import main as skix_run_all
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.io.contracts import PTInfo, save_pt_info
    from skix_torch.pipelines.run_all import main as port_run_all

    rng = np.random.default_rng(5151)
    tmp = tmp_path_factory.mktemp("side")
    _, variables, _, _ = sam3d_body_pair(rng, crop_size=32, embed_dim=24,
                                         depth=1, num_heads=6,
                                         decoder_depth=4)
    save_checkpoint(str(tmp / "sam3d.npz"), variables)
    for view in ("cam_left", "cam_right"):
        x0 = rng.uniform(5, 20, T)
        boxes = np.stack([x0, np.full(T, 4.0), x0 + 20, np.full(T, 36.0)],
                         -1).astype(np.float32)
        save_pt_info(tmp / "pt" / "p01" / f"{view}.npz", PTInfo(
            video_name=view, frame_count=T, img_shape=(H, W), fps=30.0,
            duration=T / 30.0,
            frames=rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8),
            yolo_bbox=boxes))

    def cfg(work):
        return {"paths": {"pt_root": str(tmp / "pt"), "work_root": str(work),
                          "video_root": None, "sam3d_root": None},
                "stages": ["sam3d_body", "fuse"],
                "sam3d_checkpoint": str(tmp / "sam3d.npz"), **SIZE,
                "device": "cpu"}

    cdir = tmp / "configs"
    cdir.mkdir()
    (cdir / "run_all.yaml").write_text(yaml.safe_dump(cfg(tmp / "skix")))
    skix_run_all([f"--config-dir={cdir}"])
    port_run_all(cfg(tmp / "port"))
    return tmp / "skix", tmp / "port"


def test_side_views_equal_skix(runs):
    want, got = runs
    assert sorted(p.name for p in (got / "sam3d" / "p01").iterdir()) == [
        "cam_left", "cam_right"]
    assert_same_outputs(want / "sam3d", got / "sam3d", atol=1e-4, scaled=True)


def test_fused_equal_to_skix(runs):
    want, got = runs
    assert_same_outputs(want / "fused", got / "fused", atol=1e-4)
    a = np.load(want / "fused" / "p01" / "p01_fused.npy")
    b = np.load(got / "fused" / "p01" / "p01_fused.npy")
    assert a.shape == (T, 70, 3) and np.isfinite(b).all()
    assert float(np.linalg.norm(a - b, axis=-1).mean()) < 1e-4
    summary = (got / "pipeline_summary.json").read_text()
    assert "sam3d_body" in summary and "fuse" in summary
