"""skix_torch's post-run tools against skix on the CPU: the visualizers
(``draw_2d``, ``plot_3d_frame``, ``plot_scene``, ``render_animation``,
``reprojection_panel``) pixel-equal, ``frustum_corners`` within 1e-12, and
the CLI twins of ``vis_3d_kpt`` (both modes: decoded frames and counts
equal), ``report`` (the schema equal, pose metrics within 1e-5 relative,
``report.md`` equal but for float digits, the plots pixel-equal),
``camera_calibration`` (an image directory and a video: K, dist, rms, the
CSV and the undistortion images equal) and ``validate_records`` (the JSON
equal), on the same seeded inputs. The visualizers and the calibration
are host code in both packages; the report's pose metrics run on torch."""

import json
import re

import numpy as np
import pytest

import jax

from _torch_parity import _CHEAP, assert_same_outputs, run_stage_twins

from skix.io import PTInfo, save_pt_info
from skix.io.video import read_video, write_video
from skix.pipelines import camera_calibration as scal
from skix.pipelines import report as sreport
from skix.pipelines import validate_records as svalid
from skix.pipelines import vis_3d_kpt as svis
from skix_torch.pipelines import camera_calibration as tcal
from skix_torch.pipelines import report as treport
from skix_torch.pipelines import validate_records as tvalid
from skix_torch.pipelines import vis_3d_kpt as tvis

_CAMERAS = [{"K": np.array([[900.0, 0, 640], [0, 900.0, 360], [0, 0, 1]]),
             "R": np.eye(3), "t": np.zeros(3)},
            {"K": np.array([[900.0, 0, 640], [0, 900.0, 360], [0, 0, 1]]),
             "R": np.array([[0.8, 0, -0.6], [0, 1, 0], [0.6, 0, 0.8]]),
             "t": np.array([-3.0, 0.1, 0.5]), "depth": 0.7}]


def _pose(rng, T, J):
    return (rng.normal(size=(1, J, 3)) * 0.3 + np.array([0, 0, 6.0])
            + rng.normal(size=(T, J, 3)).cumsum(0) * 0.01).astype(np.float32)


def test_visualizers_pixel_equal(tmp_path):
    from skix import vis as svisual
    from skix.vis import reprojection as srep
    from skix.vis.scene import frustum_corners as s_frustum
    from skix_torch import vis as tvisual
    from skix_torch.vis import reprojection as trep
    from skix_torch.vis.scene import frustum_corners as t_frustum

    rng = np.random.default_rng(13)
    frame = rng.integers(0, 255, (72, 96, 3), np.uint8)
    for layout, J in (("coco", 17), ("h36m", 17), ("mhr70", 70)):
        kpts = rng.uniform(-5, 100, (J, 2))
        kpts[3] = np.nan
        scores = rng.uniform(0, 1, J)
        for s in (None, scores):
            np.testing.assert_array_equal(
                tvisual.SkeletonVisualizer(layout).draw_2d(frame, kpts, s),
                svisual.SkeletonVisualizer(layout).draw_2d(frame, kpts, s))
    X = _pose(rng, 1, 17)[0]
    X[5] = np.nan
    np.testing.assert_array_equal(
        tvisual.SkeletonVisualizer("h36m").plot_3d_frame(X, title="t"),
        svisual.SkeletonVisualizer("h36m").plot_3d_frame(X, title="t"))
    sk = [_pose(rng, 1, 70)[0], _pose(rng, 1, 70)[0]]
    kw = dict(cameras=_CAMERAS, labels=["a", "b"], image_hw=(720, 1280),
              title="scene")
    np.testing.assert_array_equal(
        tvisual.SceneVisualizer("mhr70").plot_scene(sk, **kw),
        svisual.SceneVisualizer("mhr70").plot_scene(sk, **kw))
    for cam in _CAMERAS:
        args = (cam["K"], cam["R"], cam["t"], (720, 1280), 2.5)
        np.testing.assert_allclose(t_frustum(*args), s_frustum(*args),
                                   rtol=0, atol=1e-12)
    obs = rng.uniform(100, 500, (2, 17, 2))
    rep = obs + rng.normal(size=obs.shape) * 3
    obs[0, 2] = np.nan
    for f in (None, rng.integers(0, 255, (540, 960, 3), np.uint8)):
        np.testing.assert_array_equal(
            trep.reprojection_panel(f, obs[0], rep[0], title="t0"),
            srep.reprojection_panel(f, obs[0], rep[0], title="t0"))
    assert trep.reprojection_report(obs, rep) == srep.reprojection_report(
        obs, rep)
    T = 2
    k2, p3 = rng.uniform(0, 100, (T, 17, 2)), _pose(rng, T, 17)
    svisual.render_animation(k2, p3, tmp_path / "s.mp4", fps=4)
    tvisual.render_animation(k2, p3, tmp_path / "t.mp4", fps=4)
    a, b = read_video(tmp_path / "s.mp4"), read_video(tmp_path / "t.mp4")
    assert len(a) == T
    np.testing.assert_array_equal(b, a)


def _run_all_tree(root, rng, persons=2, T=6):
    """run_all-shaped outputs: fused ``(T, 70, 3)`` sequences and
    per-frame SAM-3D-Body npz files of two views."""
    for i in range(persons):
        p = f"p{i:02d}"
        fused = _pose(rng, T, 70)
        (root / "fused" / p).mkdir(parents=True)
        np.save(root / "fused" / p / f"{p}_fused.npy", fused)
        np.save(root / "fused" / p / f"{p}_smoothed.npy", fused * 0.99)
        for view in ("left", "right"):
            d = root / "sam3d" / p / f"cam_{view}"
            d.mkdir(parents=True)
            for t in range(T):
                np.savez(d / f"frame_{t:06d}.npz",
                         pred_keypoints_3d=fused[t] + 0.01 * t,
                         pred_keypoints_2d=rng.uniform(0, 900, (70, 2)))


@pytest.mark.parametrize("mode", ["fused", "prefusion"])
def test_vis_3d_kpt_twin(tmp_path, mode):
    rng = np.random.default_rng(5)
    _run_all_tree(tmp_path, rng, persons=1, T=3)
    in_root = tmp_path / ("fused" if mode == "fused" else "sam3d/p00")
    body = (f"paths:\n  in_root: {in_root}\n  out_root: '{{out}}'\n"
            f"mode: {mode}\nlayout: mhr70\nfps: 3.0\nstride: 1\n")
    skix_out, port_out = run_stage_twins(tmp_path, "vis_3d_kpt", body,
                                         svis.main, tvis.main)
    vids = sorted(p.relative_to(skix_out) for p in skix_out.rglob("*.mp4"))
    assert len(vids) == (1 if mode == "fused" else 2)
    assert vids == sorted(p.relative_to(port_out)
                          for p in port_out.rglob("*.mp4"))
    for v in vids:
        a, b = read_video(skix_out / v), read_video(port_out / v)
        assert len(a) == 3
        np.testing.assert_array_equal(b, a)


def _numbers_masked(text):
    return re.sub(r"-?\d+\.\d+(e[-+]?\d+)?", "#", text)


def test_report_twin(tmp_path, monkeypatch):
    """report over a run_all-shaped tree with a (T, 17, 3) npz and a Unity
    GT npy, plots on. skix's bone metrics are compiled once a shape
    (_CHEAP) instead of op by op (a jitted ``temporal_metrics`` would sort
    its dict's keys, and with them report.md's order)."""
    from skix.metrics import evaluation as seval

    for name in ("bone_length_cv", "symmetry_error"):
        monkeypatch.setattr(seval, name, jax.jit(
            getattr(seval, name), static_argnums=1, compiler_options=_CHEAP))
    rng = np.random.default_rng(6)
    T = 6
    _run_all_tree(tmp_path / "run", rng, persons=1, T=T)
    np.savez(tmp_path / "run" / "lifted.npz",
             kpts3d=_pose(rng, T, 17), names=np.array(["a", "b"]),
             scalar=np.float32(3.0), empty=np.zeros((0,), np.float32))
    gt = tmp_path / "gt.npy"
    np.save(gt, _pose(rng, T + 2, 70))
    body = (f"paths:\n  in_root: {tmp_path / 'run'}\n  out_root: '{{out}}'\n"
            f"patterns: ['**/*.npy', '**/*.npz']\nmax_artifacts: 8\n"
            f"plot: true\nunity_gt: {gt}\n")
    skix_out, port_out = run_stage_twins(tmp_path, "report", body,
                                         sreport.main, treport.main)
    want = json.loads((skix_out / "report.json").read_text())
    got = json.loads((port_out / "report.json").read_text())
    assert list(got) == list(want) and len(want) == 8
    assert any("gt" in r for r in want.values())
    for name, r in want.items():
        assert set(got[name]) == set(r), name
        assert got[name]["schema"] == r["schema"], name
        assert got[name].get("gt") == r.get("gt"), name
        assert got[name].get("plots") == r.get("plots"), name
        for key, s in r.get("pose", {}).items():
            g = got[name]["pose"][key]
            assert set(g) == set(s)
            for k, v in s.items():
                if isinstance(v, float):
                    np.testing.assert_allclose(g[k], v, rtol=1e-5,
                                               err_msg=f"{name}/{key}/{k}")
                else:
                    assert g[k] == v
    assert (_numbers_masked((port_out / "report.md").read_text())
            == _numbers_masked((skix_out / "report.md").read_text()))
    import matplotlib.pyplot as plt

    pngs = sorted(p.name for p in skix_out.glob("*.png"))
    assert len(pngs) == 3 * 3 and pngs == sorted(
        p.name for p in port_out.glob("*.png"))
    for p in pngs:
        np.testing.assert_array_equal(plt.imread(port_out / p),
                                      plt.imread(skix_out / p))


def _chessboard_views(n=12):
    """skix's synthetic chessboard (tests/test_vis_frontside.py:108-170):
    a 9 × 6 board affine-warped into 640 × 480 views of a known camera."""
    import cv2

    cols, rows, sq = 9, 6, 25.0
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    objp = np.zeros((cols * rows, 3), np.float32)
    objp[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * sq
    board = np.zeros(((rows + 1) * 40, (cols + 1) * 40), np.uint8)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                board[r * 40:(r + 1) * 40, c * 40:(c + 1) * 40] = 255
    src = np.array([[40, 40], [cols * 40, 40], [40, rows * 40]], np.float32)
    rngl = np.random.default_rng(2)
    views = []
    for i in range(n):
        rvec = rngl.normal(size=3) * 0.25
        tvec = np.array([-100.0 + 15 * i, -60.0, 520.0 + 12 * i])
        proj, _ = cv2.projectPoints(objp, rvec, tvec, K, np.zeros(5))
        proj = proj.reshape(-1, 2)
        if (proj.min() < 12 or proj[:, 0].max() > 628
                or proj[:, 1].max() > 468):
            continue
        dst = np.array([proj[0], proj[cols - 1], proj[(rows - 1) * cols]],
                       np.float32)
        M = cv2.getAffineTransform(src, dst)
        views.append(cv2.warpAffine(board, M, (640, 480),
                                    flags=cv2.INTER_LINEAR, borderValue=255))
    return views


@pytest.fixture
def one_cv2_thread():
    """OpenCV's calibration sums in its worker threads' order, which
    varies from run to run (K's focal ~1e-10 relative apart between two
    calls of one program): one thread makes it repeatable."""
    import cv2

    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


@pytest.mark.parametrize("source", ["images", "video"])
def test_camera_calibration_twin(tmp_path, source, one_cv2_thread):
    import cv2

    views = _chessboard_views()
    assert len(views) >= 5
    if source == "images":
        inp = tmp_path / "imgs"
        inp.mkdir()
        for i, v in enumerate(views):
            cv2.imwrite(str(inp / f"img_{i:02d}.png"), v)
        extra = ""
    else:
        inp = tmp_path / "board.mp4"
        frames = np.repeat(np.stack([np.stack([v] * 3, -1) for v in views]),
                           2, axis=0)
        write_video(inp, frames, fps=10)
        extra = "frame_stride: 2\nmax_images: 60\n"
    body = (f"paths:\n  input: {inp}\n  out_dir: '{{out}}'\nboard_cols: 9\n"
            f"board_rows: 6\nsquare_size_mm: 25.0\nuse_rational_model: false\n"
            f"prune_top_ratio: 0.1\n{extra}")
    skix_out, port_out = run_stage_twins(tmp_path, "camera_calibration",
                                         body, scal.main, tcal.main)
    assert_same_outputs(skix_out, port_out, atol=0)
    for name in ("undistort_before.png", "undistort_after.png"):
        np.testing.assert_array_equal(cv2.imread(str(port_out / name)),
                                      cv2.imread(str(skix_out / name)))
    with np.load(port_out / "calibration_parameters.npz") as z:
        assert float(z["rms"]) < 2.0


def test_validate_records_twin(tmp_path):
    root = tmp_path / "pt"
    kp = np.zeros((3, 17, 3), np.float32)
    save_pt_info(root / "p01" / "good.npz", PTInfo(
        video_name="good", frame_count=3, img_shape=(4, 4),
        yolo_keypoints=kp))
    save_pt_info(root / "p01" / "bad.npz", PTInfo(
        video_name="bad", frame_count=5, img_shape=(4, 4),
        yolo_keypoints=kp), validate=False)
    save_pt_info(root / "p02" / "v.npz", PTInfo(
        video_name="v", frame_count=3, img_shape=(4, 4),
        yolo_bbox=np.zeros((2, 4), np.float32)), validate=False)
    (root / "p02" / "v.detections.npz").write_bytes(b"skipped")
    (root / "p02" / "broken.npz").write_bytes(b"not a zip")
    reports = {}
    for side, main in (("skix", svalid.main), ("port", tvalid.main)):
        out = tmp_path / f"{side}.json"
        cdir = tmp_path / f"cfg_{side}"
        cdir.mkdir()
        (cdir / "validate_records.yaml").write_text(
            f"paths:\n  pt_root: {root}\n  report_path: {out}\n"
            "strict: false\n")
        main([f"--config-dir={cdir}"])
        reports[side] = out.read_text()
        with pytest.raises(SystemExit):
            main([f"--config-dir={cdir}", "strict=true"])
    assert reports["port"] == reports["skix"]
    rep = json.loads(reports["port"])
    assert rep["p01/good.npz"] == [] and rep["p01/bad.npz"]
    assert sorted(rep) == ["p01/bad.npz", "p01/good.npz", "p02/broken.npz",
                           "p02/v.npz"]
