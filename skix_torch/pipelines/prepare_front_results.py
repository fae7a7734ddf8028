"""Stage CLI: front-view open-vocabulary tracking (person + snow).

Port of ``skix/pipelines/prepare_front_results.py``: build the SAM3 video
predictor (``Sam3Detector`` + ``MaskMemoryTracker`` masklet propagation),
start a session on each front video, add a text prompt, propagate, save
every frame's outputs, reset, repeat for the next prompt, close. Outputs
per prompt, as skix writes them:

- ``<prompt>_masks.npy (T, K, h, w) bool`` (``save_mask_size`` rescales,
  nearest; default keeps the video resolution);
- ``<prompt>_bboxes.npy (T, K, 4)`` xyxy in frame pixels;
- ``<prompt>_scores.npy``, ``<prompt>_tracker_scores.npy``,
  ``<prompt>_active.npy``, ``<prompt>_obj_ids.npy``;
- ``person_bboxes.npy (T, 4)`` + ``person_valid.npy``, the best-track path
  that the front_side stage reads;
- ``front_summary.json`` under ``out_root``; the port adds
  ``front_timing.json`` (per-frame ``detector``/``tracker``/``outputs``
  spans).

With ``clip.checkpoint`` (a skix checkpoint npz of ``VETextEncoder``, read
through the weight bridge) text prompts go through the CLIP tower
(``clip.encoder``: the tower's keyword arguments, default the reference's
width 1024, 16 heads, 24 layers, context 32); the tokenizer's context is
the encoder's (skix's stage builds its tokenizer with CLIP's default 77,
which its 32-token encoder cannot take). ``detector: {rope_style: sam3,
pretrain_img_size: 336}`` is the detector configuration that converted
SAM3 weights need. ``tracker: {trunk: vitdet}`` gives the memory tracker
the ViT-Det trunk (patch 14, 1024 wide, depth 32, 16 heads, window 24)
in place of its conv pyramid. ``overlay_video: true`` renders each
prompt's masks, boxes and ids over the frames into ``<prompt>_overlay.mp4``
(``overlay_fps``, default 10).

``model: compact`` is skix's box-only path: the compact
:class:`~skix_torch.tracking.detector.DetrDetector` (``img_size``,
``patch_size``, ``embed_dim``, ``vit_depth``, ``num_heads``,
``num_queries``, ``decoder_depth``, ``prompt_dim``; ``checkpoint``) in
batches of ``batch_size`` frames, hash prompt embeddings, and the slot
lifecycle (``max_objects``, ``det_score_threshold``,
``min_hits_to_confirm``). It writes the box files only (no masks, no
tracker scores, no overlay), as skix does.

Without checkpoints the stage runs, loudly, with seeded random weights and
hash prompt embeddings (skix's smoke mode). :func:`process_frames` is
:func:`process_video` without the decode, for callers that hold the frames
already.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.utils.device import resolve_device
from skix_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)


def _load_into(module, path, what: str, seed: int):
    """Weights of ``module`` from the skix checkpoint npz at ``path``, or
    seeded random ones (smoke mode)."""
    from skix_torch.convert import flax_to_state_dict, load_into

    dev = next(module.parameters()).device
    if path and Path(path).exists():
        with torch.no_grad():
            load_into(module, flax_to_state_dict(path))
    else:
        if path:
            log.warning("%s checkpoint %s missing — random init", what, path)
        module.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return module.eval()


def _build_sam3(cfg, device, timer=None):
    """Sam3Detector + masklet tracker predictor, on ``device``."""
    from skix_torch.tracking.masklet import MaskletConfig
    from skix_torch.tracking.memory_tracker import MaskMemoryTracker
    from skix_torch.tracking.sam3_detector import Sam3Detector
    from skix_torch.tracking.session import VideoPredictor

    det_kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in dict(cfg.get("detector", {}) or {}).items()}
    trk_kw = dict(cfg.get("tracker", {}) or {})
    with torch.device("meta"):
        det = Sam3Detector.full_size(**det_kw)
        trk = MaskMemoryTracker(**trk_kw)
    det, trk = det.to_empty(device=device), trk.to_empty(device=device)
    ckpt = cfg.get("detector_checkpoint")
    if not (ckpt and Path(ckpt).exists()):
        log.warning("SMOKE MODE: no detector checkpoint — the %d-px "
                    "Sam3Detector runs with RANDOM weights; detections are "
                    "meaningless until a converted checkpoint is configured",
                    det.img_size)
    _load_into(det, ckpt, "detector", seed=0)
    _load_into(trk, cfg.get("tracker_checkpoint"), "tracker", seed=1)

    mcfg = MaskletConfig(
        max_objects=int(cfg.get("max_objects", 16)),
        max_dets=int(cfg.get("max_dets", 16)),
        score_threshold_detection=float(cfg.get("det_score_threshold", 0.5)),
        new_det_thresh=float(cfg.get("new_det_thresh", 0.5)),
        assoc_iou_thresh=float(cfg.get("assoc_iou_thresh", 0.5)),
        trk_assoc_iou_thresh=float(cfg.get("trk_assoc_iou_thresh", 0.5)),
        hotstart_delay=int(cfg.get("hotstart_delay", 0)),
        occlusion_suppress_iou=float(cfg.get("occlusion_suppress_iou", 0.0)))
    clip = None
    clip_cfg = dict(cfg.get("clip", {}) or {})
    clip_ckpt = clip_cfg.get("checkpoint")
    if clip_ckpt and Path(clip_ckpt).exists():
        from skix_torch.tracking.clip_text import VETextEncoder
        from skix_torch.tracking.clip_tokenizer import ClipTokenizer

        with torch.device("meta"):
            enc = VETextEncoder(d_model=det.d_model,
                                **dict(clip_cfg.get("encoder", {}) or {}))
        enc = _load_into(enc.to_empty(device=device), clip_ckpt, "clip",
                         seed=2)
        clip = (ClipTokenizer(context_length=enc.context_length), enc)
    else:
        log.warning("SMOKE MODE: no CLIP checkpoint — text prompts use the "
                    "deterministic hash embedding, not the CLIP tower")
    return VideoPredictor(det, trk, masklet_cfg=mcfg, clip=clip,
                          smoke_prompts=clip is None, timer=timer)


def _build_compact(cfg, device, timer=None):
    """The compact box-only predictor: DetrDetector + slot lifecycle."""
    from skix_torch.tracking.detector import DetrDetector
    from skix_torch.tracking.lifecycle import TrackerConfig
    from skix_torch.tracking.session import VideoPredictor

    with torch.device("meta"):
        det = DetrDetector(
            img_size=int(cfg.get("img_size", 256)),
            patch_size=int(cfg.get("patch_size", 16)),
            embed_dim=int(cfg.get("embed_dim", 192)),
            depth=int(cfg.get("vit_depth", 6)),
            num_heads=int(cfg.get("num_heads", 6)),
            num_queries=int(cfg.get("num_queries", 16)),
            decoder_depth=int(cfg.get("decoder_depth", 2)),
            prompt_dim=int(cfg.get("prompt_dim", 64)))
    ckpt = cfg.get("checkpoint")
    if not (ckpt and Path(ckpt).exists()):
        log.warning("no detector checkpoint configured — random init "
                    "(smoke mode)")
    det = _load_into(det.to_empty(device=device), ckpt, "detector", seed=0)
    tcfg = TrackerConfig(
        max_objects=int(cfg.get("max_objects", 16)),
        det_score_threshold=float(cfg.get("det_score_threshold", 0.5)),
        min_hits_to_confirm=int(cfg.get("min_hits_to_confirm", 3)))
    return VideoPredictor(det, tracker_cfg=tcfg,
                          batch_size=int(cfg.get("batch_size", 4)),
                          timer=timer)


def build_predictor(cfg, device=None, timer=None):
    model = str(cfg.get("model", "sam3"))
    device = device or resolve_device(cfg.get("device"))
    if model == "sam3":
        return _build_sam3(cfg, device, timer)
    if model == "compact":
        return _build_compact(cfg, device, timer)
    raise ValueError(f"unknown model '{model}' (sam3 | compact)")


def _resize_masks(masks, size):
    """(T, K, H, W) bool → nearest-resized (T, K, h, w) bool."""
    if size is None:
        return masks
    from skix_torch.utils.image import resize

    h, w = (int(size), int(size)) if np.isscalar(size) else map(int, size)
    T, K = masks.shape[:2]
    out = resize(torch.as_tensor(np.asarray(masks, np.float32)),
                 (T, K, h, w), "nearest")
    return out.numpy() > 0.5


def process_frames(pred, frames: np.ndarray, out_dir: Path, cfg) -> dict:
    """Track every prompt of ``cfg.prompts`` through ``frames (T, H, W, 3)``
    uint8 and write the stage's files into ``out_dir``."""
    sid = pred.start_session(frames)
    has_masks = pred.tracker is not None
    report = {}
    try:
        for prompt in list(cfg.get("prompts", ["person", "snow"])):
            pred.add_prompt(sid, prompt)
            boxes, scores, active, ids, masks, tscores = [], [], [], [], [], []
            for out in pred.propagate_in_video(sid, prompt):
                o = out["outputs"]
                boxes.append(o["bbox"])
                scores.append(o["score"])
                active.append(o["active"])
                ids.append(o["obj_id"])
                if has_masks:
                    masks.append(o["mask"])
                    tscores.append(o["tracker_score"])
            out_dir.mkdir(parents=True, exist_ok=True)
            boxes = np.stack(boxes)
            scores = np.stack(scores)
            active = np.stack(active)
            np.save(out_dir / f"{prompt}_bboxes.npy", boxes)
            np.save(out_dir / f"{prompt}_scores.npy", scores)
            np.save(out_dir / f"{prompt}_active.npy", active)
            np.save(out_dir / f"{prompt}_obj_ids.npy", np.stack(ids))
            if has_masks:
                np.save(out_dir / f"{prompt}_masks.npy",
                        _resize_masks(np.stack(masks),
                                      cfg.get("save_mask_size")))
                np.save(out_dir / f"{prompt}_tracker_scores.npy",
                        np.stack(tscores))
            if prompt == "person":
                # (T, 4) best-track path for front_side; frames with no
                # active track carry the nearest valid box
                sel = np.where(active, scores, -1.0)
                best = np.argmax(sel, axis=1)
                tt = np.arange(len(best))
                valid = sel[tt, best] > -1.0
                pb = boxes[tt, best].astype(np.float32)
                if valid.any():
                    idx = np.where(valid, tt, -1)
                    ff = np.maximum.accumulate(idx)
                    ff = np.where(ff < 0, int(np.argmax(valid)), ff)
                    pb = pb[ff]
                np.save(out_dir / "person_bboxes.npy", pb)
                np.save(out_dir / "person_valid.npy", valid)
            if has_masks and bool(cfg.get("overlay_video", False)):
                # the per-object masklet overlay video
                from skix_torch.vis.masklet import (
                    masklet_outputs_from_session, save_masklet_video)

                H, W = frames.shape[1:3]
                per_frame = {
                    t: masklet_outputs_from_session(
                        {"mask": masks[t], "bbox": boxes[t],
                         "score": scores[t], "active": active[t],
                         "obj_id": ids[t]}, (H, W))
                    for t in range(len(boxes))}
                save_masklet_video(frames, per_frame,
                                   out_dir / f"{prompt}_overlay.mp4",
                                   fps=float(cfg.get("overlay_fps", 10.0)))
            report[prompt] = {"frames": int(len(boxes)),
                              "mean_active": float(active.mean()),
                              "masks_saved": bool(has_masks)}
            pred.reset_session(sid)
    finally:
        pred.close_session(sid)
    return report


def process_video(pred, video_path: Path, out_dir: Path, cfg) -> dict:
    from skix_torch.io.video import read_video

    frames = read_video(video_path, max_frames=cfg.get("max_frames"))
    return process_frames(pred, frames, out_dir, cfg)


@cli_main("prepare_front_results")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    timer = StageTimer()
    pred = build_predictor(cfg, timer=timer)
    root = Path(cfg.paths.video_root)
    out_root = Path(cfg.paths.out_root)
    reports = {}
    for person_dir in iter_person_dirs(root, cfg):
        for vi, video in enumerate(sorted(person_dir.glob("*.mp4"))):
            # one front video per person writes the flat layout front_side
            # reads; further videos get their own <stem>/ subdir
            out_dir = out_root / person_dir.name
            if vi > 0:
                out_dir = out_dir / video.stem
                log.warning("%s: multiple front videos — %s outputs "
                            "namespaced under %s", person_dir.name,
                            video.stem, out_dir)
            try:
                reports[f"{person_dir.name}/{video.stem}"] = process_video(
                    pred, video, out_dir, cfg)
                log.info("%s/%s tracked", person_dir.name, video.stem)
            except Exception:  # noqa: BLE001
                log.exception("%s failed", video)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "front_summary.json").write_text(json.dumps(reports, indent=2))
    timer.save(out_root / "front_timing.json")


if __name__ == "__main__":
    main()
