"""The parts of ``skix/pipelines/videopose3d.py`` the VGGT stage uses: the
2D keypoint reader and the flax checkpoint reader. The lifting stage
itself comes with the kernel-free chain."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from skix_torch.io.contracts import load_pt_info


def load_2d_keypoints(path: str, source: str = "detectron2"):
    """Load (T,17,2) COCO keypoints, (T,17) scores and (H, W) from a record
    file; all float32."""
    info = load_pt_info(path)
    if source == "detectron2":
        kpts, score = info.d2_keypoints, info.d2_keypoints_score
    else:
        kpts, score = info.yolo_keypoints, info.yolo_keypoints_score
    if kpts is None:
        raise ValueError(f"{path} has no {source} keypoints")
    if kpts.shape[-1] == 3 and score is None:
        score = kpts[..., 2]
    kpts = kpts[..., :2]
    if score is None:
        score = np.ones(kpts.shape[:-1], np.float32)
    H, W = info.img_shape
    return np.asarray(kpts, np.float32), np.asarray(score, np.float32), (H, W)


def load_checkpoint(path: str | Path) -> dict:
    """A skix checkpoint npz (flat ``"params/a/b/kernel"`` keys, as skix's
    ``save_checkpoint`` writes) → nested dicts of numpy arrays. Reading it
    needs numpy only. The reference's torch ``.bin`` lifter checkpoints
    come with the lifting stage."""
    from skix_torch.convert import load_flat_npz

    p = Path(path)
    if p.suffix != ".npz":
        raise NotImplementedError(
            f"{p}: only skix .npz checkpoints are read so far; the "
            "reference's torch checkpoints come with the lifting stage")
    out: dict = {}
    for k, v in load_flat_npz(p).items():
        node = out
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out
