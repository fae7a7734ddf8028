"""skix_torch's copies of skix.config and skix.io.contracts, held against
the originals: config parsing, overrides and interpolation, the in-memory
config path, and pt records written by one package and read by the other."""

import numpy as np
import pytest

from skix import config as skix_config
from skix.io import contracts as skix_contracts
from skix_torch import config as torch_config
from skix_torch.io import contracts as torch_contracts

rng = np.random.default_rng(8)

STAGE_YAML = """
paths:
  root: /data
  out: ${paths.root}/out
  nested: ${paths.out}/deeper
model:
  depth: 4
  lr: 0.001
  taps: [4, 11, 17, 23]
  name: tiny-${model.depth}
flag: true
nothing: null
"""
OVERRIDES = ["model.depth=8", "paths.root=/tmp/x", "model.taps=[0,1]",
             "extra.key=yes", "model.lr=1e-2"]


@pytest.mark.parametrize("overrides", [[], OVERRIDES])
def test_load_config_matches_skix(tmp_path, overrides):
    (tmp_path / "stage.yaml").write_text(STAGE_YAML)
    want = skix_config.load_config("stage", overrides, config_dir=tmp_path)
    got = torch_config.load_config("stage", overrides, config_dir=tmp_path)
    assert got.to_dict() == want.to_dict()
    assert got.select("paths.nested") == want.select("paths.nested")


def test_cli_main_accepts_argv_and_mapping(tmp_path):
    (tmp_path / "stage.yaml").write_text(STAGE_YAML)
    seen = []

    @torch_config.cli_main("stage")
    def main(cfg):
        seen.append(cfg.to_dict())

    main([f"--config-dir={tmp_path}", "model.depth=2"])
    want = skix_config.load_config("stage", ["model.depth=2"],
                                   config_dir=tmp_path).to_dict()
    assert seen[-1] == want
    # a mapping is the config itself: interpolated, no file read
    main({"a": {"b": 3}, "c": "${a.b}", "d": "x-${a.b}"})
    assert seen[-1] == {"a": {"b": 3}, "c": 3, "d": "x-3"}
    main(torch_config.Cfg({"k": [1, 2]}))
    assert seen[-1] == {"k": [1, 2]}


def test_config_errors_match_skix(tmp_path):
    (tmp_path / "s.yaml").write_text("a: ${b}\nb: ${a}\n")
    for mod in (skix_config, torch_config):
        with pytest.raises(ValueError, match="recursion"):
            mod.load_config("s", config_dir=tmp_path)
        with pytest.raises(ValueError, match="key=value"):
            mod.load_config("s", ["nonsense"], config_dir=tmp_path)
    cfg = torch_config.config_from_mapping({"a": 1})
    with pytest.raises(AttributeError):
        _ = cfg.nope


def test_iter_person_dirs(tmp_path):
    for name in ("p02", "p01", "p03"):
        (tmp_path / name).mkdir()
    (tmp_path / "file.txt").write_text("")
    for only in (None, "p03,p01", ["p02"]):
        cfg = torch_config.Cfg({"only_persons": only})
        assert (torch_config.iter_person_dirs(tmp_path, cfg)
                == skix_config.iter_person_dirs(tmp_path,
                                                skix_config.Cfg(cfg.to_dict())))


def _record(T=6, H=16, W=24):
    return dict(
        video_name="clip", video_path="/x/clip.mp4", frame_count=T,
        img_shape=(H, W), fps=30.0, duration=T / 30.0,
        frames=rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8),
        depth=rng.normal(size=(T, 1, H, W)).astype(np.float32),
        none_index=np.array([2], np.int64),
        yolo_keypoints=rng.normal(size=(T, 17, 3)).astype(np.float32),
        yolo_keypoints_score=rng.random((T, 17)).astype(np.float32),
        d2_keypoints=rng.normal(size=(T, 17, 3)).astype(np.float32),
        d2_keypoints_score=rng.random((T, 17)).astype(np.float32))


@pytest.mark.parametrize("writer,reader", [
    (torch_contracts, skix_contracts),
    (skix_contracts, torch_contracts),
    (torch_contracts, torch_contracts),
])
def test_pt_info_round_trip_across_packages(tmp_path, writer, reader):
    fields = _record()
    writer.save_pt_info(tmp_path / "clip.npz", writer.PTInfo(**fields))
    back = reader.load_pt_info(tmp_path / "clip.npz")
    assert back.frame_count == 6 and back.img_shape == (16, 24)
    assert back.video_name == "clip" and back.fps == 30.0
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(back, k), v, err_msg=k)
    assert back.optical_flow is None and back.yolo_bbox is None


def test_shape_violation_raises_and_leaves_no_file(tmp_path):
    info = torch_contracts.PTInfo(frame_count=5, img_shape=(10, 10),
                                  yolo_keypoints=np.zeros((4, 17, 3),
                                                          np.float32))
    with pytest.raises(ValueError, match="YOLO/keypoints"):
        torch_contracts.save_pt_info(tmp_path / "bad.npz", info)
    assert list(tmp_path.iterdir()) == []


def test_reads_reference_pt_format(tmp_path):
    import torch

    raw = {"video_name": "v", "video_path": "p", "frame_count": 3,
           "img_shape": (4, 6), "fps": 30.0, "duration": 0.1,
           "frames": torch.zeros(3, 4, 6, 3, dtype=torch.uint8),
           "none_index": [1],
           "YOLO": {"keypoints": torch.ones(3, 17, 3)},
           "detectron2": {"bbox": torch.zeros(3, 4)}}
    torch.save(raw, tmp_path / "ref.pt")
    got = torch_contracts.load_pt_info(tmp_path / "ref.pt")
    want = skix_contracts.load_pt_info(tmp_path / "ref.pt")
    assert got.frame_count == want.frame_count == 3
    assert got.img_shape == want.img_shape == (4, 6)
    np.testing.assert_array_equal(got.yolo_keypoints, want.yolo_keypoints)
    np.testing.assert_array_equal(got.none_index, want.none_index)
    assert got.d2_bbox.shape == (3, 4)
