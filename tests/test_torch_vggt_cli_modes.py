"""Twins of ``tests/test_vggt_pipeline.py``'s ``TestSingleView`` and
``TestSfmTracksCLI``: skix and skix_torch run the vggt CLI's ``single``
and ``sfm`` modes from the same YAML config (the skix test's tiny width,
float32) on the same video, with the same weights (a skix npz of a seeded
VGGT with both DPT heads, and one of the track head), and write the same
files.

Limits: cameras, depth-derived points, tracks and visibility 1e-4,
relative to an array's largest element where that exceeds 1 (a random
camera head gives focal lengths in the thousands); the sparse model's
numbers as written (8 decimals) to the same limits; counts, colors and
identifiers equal. The track head's weights follow flax's init (see
``inputs``). The query keypoints (Shi–Tomasi, weight-free: neither
run has SuperPoint weights, so both drop ``sp`` and fall back) are equal,
as are the numbers of tracks and the reconstruction's choices.
"""

import json

import numpy as np
import pytest

from _torch_parity import close_scaled, run_stage_twins

SIZE, EMBED = 28, 32
TINY = """
mode: {mode}
checkpoint: {ckpt}
img_size: 28
patch_size: 14
embed_dim: 32
depth: 2
num_heads: 2
intermediate_layer_idx: [0, 0, 1, 1]
dtype: float32
frame_stride: {stride}
max_frames: 8
kpt_source: detectron2
ba_mode: pose_only
ba_max_steps: 5
enable_point: {point}
enable_depth: false
"""
# the skix test's sfm settings; the tracker narrower (hidden 32, two
# refinement steps against 384 and four), which cuts skix's compile time
TRACK_HIDDEN, TRACK_ITERS = 32, 2
SFM = ("sfm_max_frames: 4\nsfm_max_query_pts: 32\nsfm_query_frames: 2\n"
       "sfm_min_vis: 1\nsfm_vis_thresh: 0.0\nsfm_min_inlier_per_frame: 0\n"
       f"track_dim: 16\ntrack_hidden: {TRACK_HIDDEN}\n"
       f"track_iters: {TRACK_ITERS}\n" "track_checkpoint: {track}\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A video of random frames (the skix test's), and skix checkpoints of
    a random tiny VGGT (both heads) and of the sfm mode's track head, drawn
    from flax's init distributions (the port's seeded ``init_weights``) and
    carried to skix's tree by the inverse bridge. With every kernel at the random draw's 1/fan_in scale instead, the flow
    head amplifies rounding ~60× a refinement step, skix against itself
    (jitted against op by op) 0.6 px apart after four."""
    import torch

    from skix.io.video import write_video
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.convert import state_dict_to_flax
    from skix_torch.models.track_head import TrackHead
    from skix_torch.models.vggt import VGGT

    rng = np.random.default_rng(41)
    root = tmp_path_factory.mktemp("vggt_cli")
    write_video(root / "videos" / "p01" / "osmo_1.mp4",
                rng.integers(0, 255, (8, 32, 32, 3)).astype(np.uint8), fps=8)
    model = VGGT(img_size=SIZE, embed_dim=EMBED, depth=2, num_heads=2,
                 intermediate_layer_idx=(0, 0, 1, 1))
    model.init_weights(torch.Generator().manual_seed(41))
    save_checkpoint(str(root / "vggt.npz"),
                    state_dict_to_flax(model.state_dict()))
    head = TrackHead(dim_in=2 * EMBED, patch_size=14, features=16,
                     iters=TRACK_ITERS, hidden_size=TRACK_HIDDEN,
                     corr_levels=4, img_hw=(SIZE, SIZE), patch_start_idx=5)
    head.init_weights(torch.Generator().manual_seed(41))
    save_checkpoint(str(root / "track.npz"),
                    state_dict_to_flax(head.state_dict()))
    return root


def _run(tmp_path, inputs, mode, stride, extra=""):
    from skix.pipelines.vggt import main as skix_main
    from skix_torch.pipelines.vggt import main as port_main

    body = (f"paths:\n  video_root: {inputs / 'videos'}\n"
            f"  pt_root: {inputs / 'videos'}\n  out_root: {{out}}\n"
            + TINY.format(mode=mode, stride=stride,
                          ckpt=inputs / "vggt.npz",
                          point="true" if mode == "sfm" else "false")
            + extra)
    return run_stage_twins(tmp_path, "vggt", body, skix_main, port_main)


def test_single_view_cli_twin(tmp_path, inputs):
    want, got = _run(tmp_path, inputs, "single", 4)
    a = np.load(want / "p01" / "osmo_1_multi_view_3d_info.npz")
    b = np.load(got / "p01" / "osmo_1_multi_view_3d_info.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(b["frame_indices"], [0, 4])
    for k in a.files:
        assert a[k].shape == b[k].shape, k
        close_scaled(b[k], a[k], 1e-4)
    s_rep = json.loads((want / "vggt_summary.json").read_text())
    t_rep = json.loads((got / "vggt_summary.json").read_text())
    assert s_rep.keys() == t_rep.keys() == {"p01/osmo_1"}
    assert t_rep["p01/osmo_1"]["frames_processed"] == 2
    assert (got / "vggt_timing.json").exists()


def _token(t):
    try:
        return float(t)
    except ValueError:
        return t


def _numbers(path):
    """A text file's lines: comment lines as they are, the others as lists
    of tokens (numbers as floats)."""
    return [ln if ln.startswith("#") else [_token(t) for t in ln.split()]
            for ln in path.read_text().splitlines()]


def test_sfm_cli_twin(tmp_path, inputs):
    want, got = _run(tmp_path, inputs, "sfm", 2,
                     SFM.format(track=inputs / "track.npz"))
    s_rep = json.loads((want / "vggt_summary.json").read_text())["p01/osmo_1"]
    t_rep = json.loads((got / "vggt_summary.json").read_text())["p01/osmo_1"]
    assert set(s_rep) == set(t_rep)
    for k in ("frames", "num_tracks", "reconstruction", "valid_tracks"):
        assert t_rep[k] == s_rep[k], k
    assert t_rep["reconstruction"] is True and t_rep["num_tracks"] > 0
    for k in ("ba_initial_cost", "ba_final_cost"):
        np.testing.assert_allclose(t_rep[k], s_rep[k], rtol=1e-4)
    assert t_rep["ba_final_cost"] <= t_rep["ba_initial_cost"] + 1e-6

    a = np.load(want / "p01" / "osmo_1_sfm_tracks.npz")
    b = np.load(got / "p01" / "osmo_1_sfm_tracks.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(b["colors"], a["colors"])
    for k in a.files:
        assert a[k].shape == b[k].shape, k
        close_scaled(b[k], a[k], 1e-4)

    sparse_a, sparse_b = (d / "p01" / "osmo_1_sparse" for d in (want, got))
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        ra, rb = _numbers(sparse_a / name), _numbers(sparse_b / name)
        assert len(ra) == len(rb), name
        for la, lb in zip(ra, rb):
            if isinstance(la, str):
                assert la == lb
                continue
            assert len(la) == len(lb), name
            for x, y in zip(la, lb):
                if isinstance(x, float):
                    close_scaled(y, x, 1e-4)
                else:
                    assert x == y, name
