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

``detector_name: vitdet`` puts skix's human detector in the loop for
records without person boxes: the cascade Mask R-CNN over a ViT-Det trunk
(``detector_embed_dim``, ``detector_depth``, ``detector_num_heads``,
``detector_window``, ``detector_global_indexes``, ``detector_image_size``;
:mod:`skix_torch.models.cascade_rcnn`) finds up to ``max_people`` people a
frame (``detector_batch`` frames a forward, ``detector_bbox_thr``), the
estimator runs on every slot, and the athlete of each frame is the closest
to the camera with temporal continuity (``select_closest_person``; a frame
without a detection carries the last pick, ``det_valid`` false).

``checkpoint``, ``fov_checkpoint`` and ``detector_checkpoint`` are skix
checkpoint npz files, read through ``skix_torch.convert`` (a torch
checkpoint raises ``ValueError``: convert a detectron2 state dict with
``cascade_rcnn.convert_detectron2_cascade_vitdet`` first); without them
the models run, loudly, with seeded random weights (skix's smoke mode).
The models run on ``cfg.device`` (default ``cuda``).
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

import numpy as np
import torch

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


def build_human_detector(cfg, device=None):
    """The detector in the loop for records without person boxes
    (``detector_name: vitdet``: the cascade Mask R-CNN over a ViT-Det
    trunk, :class:`~skix_torch.models.cascade_rcnn.HumanDetector`), or None
    for ``detector_name: null`` or ``''``."""
    name = cfg.get("detector_name") or ""
    if not name:
        return None
    if name != "vitdet":
        raise ValueError(f"unknown detector_name {name!r} (only 'vitdet')")
    from skix_torch.models.cascade_rcnn import CascadeMaskRCNN, HumanDetector

    ckpt = cfg.get("detector_checkpoint")
    if ckpt and Path(ckpt).suffix in (".bin", ".pth", ".pt"):
        raise ValueError(
            f"detector_checkpoint={ckpt} is a torch checkpoint; convert it "
            "offline with skix_torch.models.cascade_rcnn."
            "convert_detectron2_cascade_vitdet and save the skix npz")
    device = resolve_device(device or cfg.get("device", "cuda"))
    image_size = int(cfg.get("detector_image_size", 1024))
    with torch.device("meta"):     # no default init to throw away
        model = CascadeMaskRCNN(
            embed_dim=int(cfg.get("detector_embed_dim", 1280)),
            depth=int(cfg.get("detector_depth", 32)),
            num_heads=int(cfg.get("detector_num_heads", 16)),
            window_size=int(cfg.get("detector_window", 14)),
            global_indexes=tuple(
                cfg.get("detector_global_indexes", (7, 15, 23, 31))),
            image_size=image_size)
    model = model.to_empty(device=device)
    sd = _state_dict(ckpt, "human-detector")
    if sd is None:
        model.init_weights(torch.Generator(device=device).manual_seed(0))
    else:
        from skix_torch.convert import load_into

        with torch.no_grad():
            load_into(model, sd)
    return HumanDetector(model, image_size=image_size)


def _process_detected_people(estimator, frames, human_detector, cfg,
                             image_focal=None):
    """The detector in the loop: every detected person slot through the
    estimator, then per frame the athlete (closest camera depth with
    temporal continuity); a frame with no detection carries the previous
    pick (``det_valid`` false) and leaves the continuity term on the last
    real one."""
    from skix_torch.models.sam3d_body import select_closest_person

    det_boxes, det_valid = human_detector.detect_clip(
        frames,
        batch_size=int(cfg.get("detector_batch", 4)),
        bbox_thr=float(cfg.get("detector_bbox_thr", 0.5)),
        max_people=int(cfg.get("max_people", 4)))
    T, n_slots = det_valid.shape
    per_slot = [estimator.process_clip(
        frames, det_boxes[:, n],
        batch_size=int(cfg.get("batch_size", 8)),
        image_focal=image_focal,
        inference_type=str(cfg.get("inference_type", "body")))
        for n in range(n_slots)]
    outputs, prev = [], None
    for t in range(T):
        cands = [per_slot[n][t] for n in range(n_slots) if det_valid[t, n]]
        pick = select_closest_person(cands, prev)
        ok = pick is not None
        if pick is None:
            pick = prev if prev is not None else per_slot[0][t]
        else:
            prev = pick
        outputs.append(dict(pick, det_valid=np.asarray(ok)))
    return outputs


def process_one_video(estimator, record_path: Path, out_dir: Path, cfg,
                      fov_estimator=None, human_detector=None) -> int:
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
        if human_detector is not None:
            outputs = _process_detected_people(
                estimator, info.frames, human_detector, cfg,
                image_focal=image_focal)
            _save_frames_atomic(out_dir, outputs)
            return len(outputs)
        # no detector: one full-image box a frame
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
    estimator = build_estimator(cfg, device)
    fov_estimator = build_fov_estimator(cfg, device)
    human_detector = build_human_detector(cfg, device)
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
                                      fov_estimator=fov_estimator,
                                      human_detector=human_detector)
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
