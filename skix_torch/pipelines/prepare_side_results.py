"""Stage CLI: side-view videos → per-frame MHR-70 body estimates.

Port of ``skix/pipelines/prepare_side_results.py``. For each person and
side-view record (``*.npz``/``*.pt`` with stored frames): the person boxes
(``yolo_bbox``, else ``d2_bbox``, else one full-image box per frame), the
optional person masks (``use_mask``: the record's ``yolo_mask``), the
optional MoGe-2 focal (``fov_name: moge2``: one estimate per
``fov_stride`` frames, repeated), then :class:`SAM3DBodyEstimator`'s
batched clip inference (``inference_type``: ``body``, or ``full`` with the
hand branch). Outputs, as skix writes them:
``<out_root>/<person>/<record>/frame_%06d_sam_3d_body_outputs.npz`` (the
reference field names, read by the fuse stage's loader), each record's
directory written under a temporary name and renamed into place, and
``sam3d_summary.json`` (frames per record, −1 for a record that failed:
per-video errors are logged and swallowed, as in skix). A record whose
output directory exists is skipped unless ``overwrite``.

``checkpoint`` and ``fov_checkpoint`` are skix checkpoint npz files, read
through ``skix_torch.convert``; without them the models run, loudly, with
seeded random weights (skix's smoke mode). The models run on
``cfg.device`` (default ``cuda``). ``detector_name: vitdet`` (the cascade
Mask R-CNN detector in the loop) is not ported and raises.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

import numpy as np

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def _state_dict(path, what: str):
    """The port's state dict of the skix checkpoint npz at ``path``, or None
    (with skix's smoke-mode warning) when none is configured."""
    from skix_torch.convert import flax_to_state_dict

    if path and Path(path).exists():
        return flax_to_state_dict(path)
    log.warning("no %s checkpoint configured — random init (smoke mode)",
                what)
    return None


def build_estimator(cfg, device=None):
    from skix_torch.models.sam3d_body import SAM3DBody, SAM3DBodyEstimator

    device = resolve_device(device or cfg.get("device", "cuda"))
    with device:    # built on the card: no host-side init and copy
        model = SAM3DBody(
            crop_size=int(cfg.get("crop_size", 256)),
            patch_size=int(cfg.get("patch_size", 16)),
            embed_dim=int(cfg.get("embed_dim", 384)),
            depth=int(cfg.get("vit_depth", 8)),
            num_heads=int(cfg.get("num_heads", 6)),
            decoder_depth=int(cfg.get("decoder_depth", 4)),
            focal_length=float(cfg.get("crop_focal", 5000.0)),
            backbone=str(cfg.get("backbone", "vit_hmr")),
        )
    return SAM3DBodyEstimator(model, _state_dict(cfg.get("checkpoint"),
                                                 "SAM3DBody"), device=device)


def build_fov_estimator(cfg, device=None):
    """Optional MoGe-2 FOV estimator (``fov_name: moge2``): the clip's
    intrinsics, of which the stage keeps the vertical focal. ``fov_name:
    null`` disables it."""
    name = cfg.get("fov_name") or ""
    if not name:
        return None
    if name != "moge2":
        raise ValueError(f"unknown fov_name {name!r} (only 'moge2')")
    from skix_torch.models.moge import MoGeFovEstimator, MoGePointModel

    device = resolve_device(device or cfg.get("device", "cuda"))
    depth = int(cfg.get("fov_depth", 24))
    taps = cfg.get("fov_taps")
    if taps is None:
        # evenly spaced 4-tap default scaled to the configured depth
        taps = [max(0, (i + 1) * depth // 4 - 1) for i in range(4)]
    with device:
        model = MoGePointModel(
            patch_size=int(cfg.get("fov_patch_size", 14)),
            embed_dim=int(cfg.get("fov_embed_dim", 1024)),
            depth=depth,
            num_heads=int(cfg.get("fov_num_heads", 16)),
            taps=tuple(int(t) for t in taps),
        )
    return MoGeFovEstimator(model, _state_dict(cfg.get("fov_checkpoint"),
                                               "MoGe FOV"), device=device)


def build_human_detector(cfg):
    """The detector in the loop for records without person boxes
    (``detector_name: vitdet``: skix's cascade Mask R-CNN over a ViT-Det-H
    trunk). Not ported: it raises, naming its ROADMAP item; ``detector_name:
    null`` or ``''`` disables it."""
    name = cfg.get("detector_name") or ""
    if not name:
        return None
    if name != "vitdet":
        raise ValueError(f"unknown detector_name {name!r} (only 'vitdet')")
    raise NotImplementedError(
        "detector_name: vitdet (skix.models.cascade_rcnn, the cascade Mask "
        "R-CNN human detector) is not ported to skix_torch yet: ROADMAP "
        "Queue 1, item 10 (with keypoint_rcnn's RoI heads); give the records "
        "person boxes, or run skix.pipelines.prepare_side_results")


def process_one_video(estimator, record_path: Path, out_dir: Path, cfg,
                      fov_estimator=None) -> int:
    from skix_torch.io.contracts import load_pt_info

    info = load_pt_info(record_path)
    if info.frames is None:
        raise ValueError(f"{record_path} has no stored frames")
    bboxes = info.yolo_bbox if info.yolo_bbox is not None else info.d2_bbox
    image_focal = None
    if fov_estimator is not None:
        # MoGe per strided frame, its vertical focal repeated over the stride
        stride = max(1, int(cfg.get("fov_stride", 8)))
        Ks = fov_estimator.intrinsics_for_clip(info.frames[::stride])
        image_focal = np.repeat(Ks[:, 1, 1], stride)[: info.frames.shape[0]]
    if bboxes is None:
        # skix's detector in the loop would pick the athlete here
        # (build_human_detector: not ported); one full-image box a frame
        T, H, W = info.frames.shape[:3]
        log.warning("%s has no person bboxes and no detector configured "
                    "— full-image crops", record_path.name)
        bboxes = np.tile(np.asarray([0.0, 0.0, W, H], np.float32), (T, 1))
    masks = None
    if bool(cfg.get("use_mask", False)):
        if info.yolo_mask is not None:
            masks = np.asarray(info.yolo_mask)
        else:
            log.warning("use_mask=true but %s has no yolo_mask — "
                        "running unconditioned", record_path.name)
    outputs = estimator.process_clip(
        info.frames, np.asarray(bboxes, np.float32),
        batch_size=int(cfg.get("batch_size", 8)),
        image_focal=image_focal,
        inference_type=str(cfg.get("inference_type", "body")),
        masks=masks)
    _save_frames_atomic(out_dir, outputs)
    return len(outputs)


def _save_frames_atomic(out_dir: Path, outputs) -> None:
    """Write the per-frame npz set into ``<out_dir>.tmp``, then rename it
    into place: the resume-by-existence skip never takes a directory that a
    killed run left half written for a finished one."""
    tmp = out_dir.parent / (out_dir.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    for t, out in enumerate(outputs):
        np.savez(tmp / f"frame_{t:06d}_sam_3d_body_outputs.npz", **out)
    if out_dir.exists():
        shutil.rmtree(out_dir)
    tmp.rename(out_dir)


@cli_main("sam3d_body")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(str(cfg.get("device", "cuda")))
    build_human_detector(cfg)    # raises for the unported detector
    estimator = build_estimator(cfg, device)
    fov_estimator = build_fov_estimator(cfg, device)
    root = Path(cfg.paths.pt_root)
    out_root = Path(cfg.paths.out_root)
    report = {}
    for person_dir in iter_person_dirs(root, cfg):
        for rec in (sorted(person_dir.glob("*.npz"))
                    + sorted(person_dir.glob("*.pt"))):
            if rec.name.endswith(".detections.npz"):
                continue
            out_dir = out_root / person_dir.name / rec.stem
            if out_dir.exists() and not bool(cfg.get("overwrite", False)):
                continue
            try:
                n = process_one_video(estimator, rec, out_dir, cfg,
                                      fov_estimator=fov_estimator)
                report[f"{person_dir.name}/{rec.stem}"] = n
                log.info("%s/%s: %d frames", person_dir.name, rec.stem, n)
            except Exception:  # noqa: BLE001 — per-video isolation + summary
                log.exception("%s failed", rec)
                report[f"{person_dir.name}/{rec.stem}"] = -1
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "sam3d_summary.json").write_text(json.dumps(report, indent=2))
    failures = sum(1 for v in report.values() if v == -1)
    log.info("done: %d videos, %d failures", len(report), failures)


if __name__ == "__main__":
    main()
