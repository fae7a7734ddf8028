"""skix_torch's visualization against skix's, on the CPU: the masklet
overlay (``vis/masklet.py``, a copy: frames equal byte for byte), the
frame-directory merge, the 3D BEV rasterizer (``vis/render3d.py``) and
the front_side stage with ``render3d: true``, against skix's and through
run_all.

The rasterizer decides each pixel by strict float comparisons (edge
functions, depth tests); two float32 evaluations may round a pixel on an
edge to the other side. Rendered frames therefore agree on at least
99.9 % of their pixels, as the mask slot of prepare_dataset does; depths
where both are finite within 1e-4 relative. The stage twins also compare
every array file (1e-4, relative to the array's largest element where
that exceeds 1) and the videos' frame counts.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skix.vis import masklet as SM
from skix.vis import render3d as SR
from skix_torch.vis import masklet as PM
from skix_torch.vis import render3d as PR

H, W = 96, 128


def _frame_count(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def _session_frame(seed, K=3, h=32, w=40):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 20, (K, 2))
    return {"mask": rng.random((K, h, w)) > 0.6,
            "bbox": np.concatenate([xy, xy + rng.uniform(5, 15, (K, 2))],
                                   -1).astype(np.float32),
            "score": rng.random(K).astype(np.float32),
            "active": np.array([True, False, True]),
            "obj_id": np.array([4, 9, 300])}


def test_masklet_overlay_frames_equal_skix(tmp_path):
    """The adapter, the rendered frames (uint8 and float input, masks at
    and below the frame size, the frame banner), the per-object mask
    table and the overlay mp4's frame count."""
    np.testing.assert_array_equal(PM.pascal_color_map(),
                                  SM.pascal_color_map())
    np.testing.assert_array_equal(PM.generate_colors(7, seed=2),
                                  SM.generate_colors(7, seed=2))
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (3, 32, 40, 3), dtype=np.uint8)
    per_frame = {}
    for t in range(3):
        out = _session_frame(t)
        got = PM.masklet_outputs_from_session(out, (32, 40))
        want = SM.masklet_outputs_from_session(out, (32, 40))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        per_frame[t] = got
        for img in (frames[t], frames[t].astype(np.float32) / 255.0):
            np.testing.assert_array_equal(
                PM.render_masklet_frame(img, got, frame_idx=t),
                SM.render_masklet_frame(img, want, frame_idx=t))
        low = dict(got, out_binary_masks=got["out_binary_masks"][:, ::2, ::2])
        np.testing.assert_array_equal(
            PM.render_masklet_frame(frames[t], low, alpha=0.3),
            SM.render_masklet_frame(frames[t], low, alpha=0.3))
    got = PM.prepare_masks_for_visualization(per_frame)
    want = SM.prepare_masks_for_visualization(per_frame)
    assert got.keys() == want.keys()
    for t in got:
        assert got[t].keys() == want[t].keys()
    path = PM.save_masklet_video(frames, per_frame, tmp_path / "o.mp4",
                                 fps=5.0)
    assert _frame_count(path) == 3


def test_merge_frames_to_video(tmp_path):
    import cv2

    from skix.io.video import merge_frames_to_video as skix_merge
    from skix_torch.io.video import merge_frames_to_video

    rng = np.random.default_rng(2)
    (tmp_path / "frames").mkdir()
    for i in range(4):
        cv2.imwrite(str(tmp_path / "frames" / f"{i:03d}.png"),
                    rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    n = merge_frames_to_video(tmp_path / "frames", tmp_path / "m.mp4", fps=4)
    assert n == skix_merge(tmp_path / "frames", tmp_path / "s.mp4", fps=4)
    assert n == 4 and _frame_count(tmp_path / "m.mp4") == 4
    assert merge_frames_to_video(tmp_path / "none", tmp_path / "x.mp4") == 0


def _same_pixels(got, want, share=0.999, atol=0.0):
    """At least ``share`` of the pixels agree: every channel equal (uint8
    frames) or within ``atol`` (float32 shading)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    same = np.abs(got.astype(np.float64) - want) <= atol
    same = same.all(-1) if got.ndim == 3 else same
    assert same.mean() >= share, same.mean()


def _scene(seed):
    """A slanted quad, a box seen from above, overlapping triangles, one
    behind the camera; lines (one through a triangle), spheres."""
    rng = np.random.default_rng(seed)
    bv, bt = PR.make_box((2.0, 1.0, 2.0), (-1.0, -0.5, 0.0))
    tris = np.concatenate([PR.flatten_mesh(bv, bt),
                           rng.uniform(-2, 2, (20, 3, 3)).astype(np.float32)
                           + np.array([0, 0, 1], np.float32),
                           np.array([[[0, 0, -9.0], [1, 0, -9], [0, 1, -9]]],
                                    np.float32)])
    cols = rng.random((len(tris), 3)).astype(np.float32)
    segs = rng.uniform(-2, 2, (5, 2, 3)).astype(np.float32)
    pts = rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32)
    return (tris, cols, np.arange(len(tris)) != 3, segs,
            rng.random((5, 3)).astype(np.float32),
            np.array([True, True, False, True, True]),
            pts, np.full(4, 0.3, np.float32),
            rng.random((4, 3)).astype(np.float32),
            np.array([True, True, True, False]))


def test_render_frame_matches_skix():
    """Triangles in chunks of 8 (the z-buffer carried across chunks),
    lines z-tested against them, sphere impostors; the colors (float32
    shading, within 1e-5) on at least 99.9 % of pixels, depths within 1e-4
    relative."""
    tris, cols, ok, segs, scols, sok, pc, pr, pcol, pok = _scene(3)
    R, eye = PR.look_at((0.5, -1.0, -6.0), (0.0, 0.0, 0.5), (0.0, -1.0, 0.0))
    sR, seye = SR.look_at((0.5, -1.0, -6.0), (0.0, 0.0, 0.5),
                          (0.0, -1.0, 0.0))
    np.testing.assert_allclose(R, np.asarray(sR), atol=1e-6)
    K = PR.intrinsics_from_fov(60.0, H, W)
    args = (tris, cols, ok, segs, scols, sok, R, eye, K)
    pts = (pc, pr, pcol, pok)
    want_c, want_d = SR.render_frame(
        *(jnp.asarray(a) for a in args), height=H, width=W, chunk=8,
        **dict(zip(("point_centers", "point_radii", "point_colors",
                    "point_valid"), (jnp.asarray(a) for a in pts))))
    got_c, got_d = PR.render_frame(
        *(torch.as_tensor(a) for a in args), height=H, width=W, chunk=8,
        **dict(zip(("point_centers", "point_radii", "point_colors",
                    "point_valid"), (torch.as_tensor(a) for a in pts))))
    want_c, want_d = np.asarray(want_c), np.asarray(want_d)
    assert np.isfinite(want_d).mean() > 0.1
    _same_pixels(got_c.numpy(), want_c, atol=1e-5)
    both = np.isfinite(want_d) & np.isfinite(got_d.numpy())
    assert (both == np.isfinite(want_d)).mean() >= 0.999
    close_d = np.isclose(got_d.numpy()[both], want_d[both], rtol=1e-4)
    assert close_d.mean() >= 0.999


@pytest.mark.parametrize("mode", ["impostor", "mesh"])
def test_bev_renderer_frames_match_skix(mode, tmp_path):
    """``BevVideoRenderer.render`` on a moving skeleton with a keypoint
    gone (non-finite): each BGR frame on at least 99.9 % of pixels, and
    the mp4 holds every frame."""
    rng = np.random.default_rng(4)
    kw = dict(width=W, height=H, kp_mode=mode, kp_radius=0.5,
              sphere_subdiv=1, chunk=16,
              edges=((0, 1), (1, 2), (2, 3), (3, 4), (1, 5)))
    view = (dict(lookat=(0.0, 0.0, 10.0), eye_height=20.0))
    got_r = PR.BevVideoRenderer(tmp_path / "p.mp4", view=PR.BevView(**view),
                                device="cpu", **kw)
    want_r = SR.BevVideoRenderer(None, view=SR.BevView(**view), **kw)
    base = rng.uniform(-3, 3, (6, 3)) + np.array([0, 1.0, 10.0])
    for t in range(3):
        kpts = (base + 0.2 * t).astype(np.float32)
        if t == 1:
            kpts[2] = np.nan
        _same_pixels(got_r.render(kpts), want_r.render(kpts))
    got_r.close()
    assert _frame_count(tmp_path / "p.mp4") == 3


def _front_side_inputs(root, T=3):
    rng = np.random.default_rng(5)
    side = root / "side" / "p01"
    side.mkdir(parents=True)
    base = rng.normal(size=(T, 70, 3)).cumsum(0) * 0.02
    np.save(side / "left_view.npy", base.astype(np.float32))
    np.save(side / "right_view.npy",
            (base + rng.normal(size=base.shape) * 0.01).astype(np.float32))
    front = root / "front" / "p01"
    front.mkdir(parents=True)
    bbox = np.tile(np.array([900.0, 400, 1000, 800], np.float32), (T, 1))
    bbox[:, [1, 3]] += np.arange(T)[:, None] * 20      # moving downhill
    np.save(front / "person_bboxes.npy", bbox)


def _recording(monkeypatch, module, frames):
    """Record every frame ``module.BevVideoRenderer.render`` returns."""
    render = module.BevVideoRenderer.render

    def rec(self, kpts):
        frames.append(render(self, kpts))
        return frames[-1]
    monkeypatch.setattr(module.BevVideoRenderer, "render", rec)


def test_front_side_render3d_matches_skix(tmp_path, monkeypatch):
    """The stage with ``render3d: true`` at a small render size through
    both CLIs: the 3D BEV frames (≥ 99.9 % of pixels), both videos' frame
    counts, the arrays and the summary."""
    from _torch_parity import assert_same_outputs

    from skix.pipelines.front_side import main as skix_main
    from skix_torch.pipelines.front_side import main as port_main

    _front_side_inputs(tmp_path)
    frames = {"skix": [], "port": []}
    _recording(monkeypatch, SR, frames["skix"])
    _recording(monkeypatch, PR, frames["port"])
    for side, fn in (("skix", skix_main), ("port", port_main)):
        cdir = tmp_path / f"cfg_{side}"
        cdir.mkdir()
        body = {"paths": {"side_root": str(tmp_path / "side"),
                          "front_root": str(tmp_path / "front"),
                          "out_root": str(tmp_path / side)},
                "meters_per_pixel": 0.02, "fps": 6.0, "render3d": True,
                "render3d_width": W, "render3d_height": H,
                "render3d_eye_height": 4.0, "render3d_kp_radius": 0.05,
                **({"device": "cpu"} if side == "port" else {})}
        (cdir / "front_side.yaml").write_text("\n".join(
            f"{k}: {json.dumps(v)}" for k, v in body.items()) + "\n")
        fn([f"--config-dir={cdir}"])
    assert len(frames["port"]) == len(frames["skix"]) == 3
    for g, w in zip(frames["port"], frames["skix"]):
        _same_pixels(g, w)
    for side in ("port", "skix"):
        assert _frame_count(tmp_path / side / "p01" / "p01_bev3d.mp4") == 3
    assert_same_outputs(tmp_path / "skix", tmp_path / "port", atol=1e-4,
                        scaled=True)


def test_run_all_front_side_render3d(tmp_path, monkeypatch):
    """run_all's front_side with ``render3d: true`` forwards it to the
    stage: its default 1280 × 720 render of the one frame, the same frame
    as the stage renders from the same inputs (the stage's frames are held
    to skix's by the twin above), and the stage's video."""
    from skix_torch.pipelines.front_side import main as fs_main
    from skix_torch.pipelines.run_all import main as port_run_all

    _front_side_inputs(tmp_path, T=1)
    frames = []
    _recording(monkeypatch, PR, frames)
    port_run_all({"paths": {"pt_root": str(tmp_path / "pt"),
                            "work_root": str(tmp_path / "work"),
                            "sam3d_root": str(tmp_path / "side"),
                            "front_root": str(tmp_path / "front"),
                            "video_root": None},
                  "stages": ["front_side"], "render3d": True,
                  "device": "cpu"})
    fs_main({"paths": {"side_root": str(tmp_path / "side"),
                       "front_root": str(tmp_path / "front"),
                       "out_root": str(tmp_path / "stage")},
             "render3d": True, "device": "cpu"})
    assert len(frames) == 2 and frames[0].shape == (720, 1280, 3)
    np.testing.assert_array_equal(frames[0], frames[1])
    assert _frame_count(tmp_path / "work" / "front_side" / "p01"
                        / "p01_bev3d.mp4") == 1
