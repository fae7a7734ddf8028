"""Stage CLI: video → per-video record (the ``pt_info`` npz contract).

Port of ``skix/pipelines/prepare_dataset.py``. Per person directory and
``*.mp4`` video: decode in chunks, run the configured backend, select one
athlete per frame and fill the holes, assemble the record, check its
shapes and save it atomically; a finished record is skipped unless
``overwrite``, and a video that fails is logged and skipped (skix's
per-video isolation: callers check the files).

Backends (a registry, as in skix):

- ``precomputed``: the sidecar ``<video>.detections.npz`` (boxes (T,N,4)
  cxcywh, keypoints (T,N,17,3), det_valid (T,N), optional depth and
  optical_flow).
- ``skix``: the perception models on ``device``: ``pose_model`` ``yolo``
  (YOLO11/v8 pose, ``yolo_scale``/``yolo_version``) or ``compact`` (the
  CenterNet); ``bbox_model: detect`` (a separate YOLO detect run with the
  person filter, tracked on its own); ``tasks`` ``mask`` (YOLO seg →
  ``yolo_mask``), ``depth`` (the DPT ViT/16 through the attention kernel:
  the frame cropped to /16, the depth edge-padded back, the last batch
  padded to ``depth_batch``), ``optical_flow`` (RAFT, corr levels 3,
  radius 3); ``d2_model: rcnn`` (Keypoint R-CNN R50-FPN into the d2_*
  slots; ``none`` mirrors the primary source); ``tracking`` (ByteTrack
  ids, the ``bytetrack`` block; ``tracker_type: botsort`` fits camera
  motion on the flow task's output).

Selection and filling run on the device (``perception.selection``). The
mask slot upsamples the selected proto-grid probabilities with jax's
bilinear resize to the /32-padded frame and thresholds them at 0.5.

Weights: each model's ``*_checkpoint`` key names a skix npz (flax
variables, read with numpy only); a torch checkpoint (``.pt``, ``.pth``,
``.bin``) raises a ``ValueError`` naming the converter to run first
(skix's stage hands such a file to the lifter's loader, which fails).
With no checkpoint a model is initialized from a CPU ``torch.Generator``
with flax's distributions (smoke mode: these weights differ from skix's
``PRNGKey`` draws by design). Models are built once per configuration and
device and kept across videos. ``device`` (default ``cuda``) selects where
the models run.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.io.contracts import PTInfo, check_pt_info_shapes, save_pt_info
from skix_torch.io.video import probe_video, read_video_chunks
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# task registry: name -> factory(cfg, video_path) -> callable(frames_u8)
_BACKENDS: Dict[str, Callable] = {}

# the converter to run offline for a reference checkpoint on each key
CONVERTERS = {
    "yolo_checkpoint": "skix_torch.models.yolo_pose.convert_ultralytics_pose",
    "seg_checkpoint": "skix_torch.models.yolo_pose.convert_ultralytics_seg",
    "bbox_checkpoint":
        "skix_torch.models.yolo_pose.convert_ultralytics_detect",
    "d2_checkpoint": ("skix_torch.models.keypoint_rcnn."
                      "convert_detectron2_keypoint_rcnn"),
    "depth_checkpoint": "skix_torch.models.dpt.convert_hf_dpt_checkpoint",
    "flow_checkpoint": "a RAFT converter (none is ported)",
    "detector_checkpoint": "a compact-detector converter (none exists)",
}


def register_backend(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn

    return deco


@register_backend("precomputed")
def _precomputed_backend(cfg, video_path: Path):
    """Padded raw detections from ``<video>.detections.npz``: boxes
    (T,N,4) cxcywh, keypoints (T,N,17,3), det_valid (T,N), optional depth
    (T,1,H,W), optical_flow (T-1,2,H,W)."""
    sidecar = video_path.with_suffix(".detections.npz")

    def run(frames: np.ndarray) -> dict:
        if not sidecar.exists():
            raise FileNotFoundError(f"precomputed backend needs {sidecar}")
        with np.load(sidecar, allow_pickle=False) as z:
            return dict(z)

    return run


def _stage_device(cfg) -> torch.device:
    return resolve_device(str(cfg.get("device", "cuda")))


def _chunked_clip_detect(frames, batch_size: int, pad_hw, detect_chunk,
                         device):
    """Shared whole-clip detection driver: fixed-size batches with /32
    spatial zero padding, xyxy → cxcywh for selection. ``detect_chunk(chunk)
    -> (boxes_xyxy, payload, valid, scores)`` is the model-specific part;
    ``frames`` may already lie on ``device`` (uint8)."""
    T = frames.shape[0]
    ph, pw = pad_hw
    boxes, kpts, valid, scores = [], [], [], []
    for s in range(0, T, batch_size):
        e = min(s + batch_size, T)
        chunk = torch.as_tensor(frames[s:e], device=device
                                ).to(torch.float32) / 255.0
        chunk = F.pad(chunk, (0, 0, 0, pw, 0, ph, 0, batch_size - (e - s)))
        bx, kp, vl, sc = detect_chunk(chunk)
        n = e - s
        b = bx[:n].cpu().numpy()
        boxes.append(np.stack([(b[..., 0] + b[..., 2]) / 2,
                               (b[..., 1] + b[..., 3]) / 2,
                               b[..., 2] - b[..., 0],
                               b[..., 3] - b[..., 1]], -1))
        kpts.append(kp[:n].cpu().numpy())
        valid.append(vl[:n].cpu().numpy())
        scores.append(sc[:n].cpu().numpy())
    return (np.concatenate(boxes), np.concatenate(kpts),
            np.concatenate(valid), np.concatenate(scores))


def _compute_track_ids(cfg, boxes_cxcywh, scores, valid, flow=None,
                       device=None) -> np.ndarray:
    """(T, N) det→track-id map by ByteTrack on ``device``, from the
    ``bytetrack`` block; ``tracker_type: botsort`` adds camera-motion
    compensation fitted on the flow task's ``flow (T-1, 2, H, W)``
    (subsampled on the host on skix's stride-16 grid), plain ByteTrack
    when the flow task is off."""
    from skix_torch.perception.byte_track import (ByteTrackConfig,
                                                  fit_global_motion,
                                                  motion_grid,
                                                  track_sequence_ids)
    from skix_torch.tracking.matcher import cxcywh_to_xyxy

    dev = device or _stage_device(cfg)
    raw = dict(cfg.get("bytetrack", {}) or {})
    use_gmc = (raw.get("tracker_type") == "botsort" and flow is not None
               and flow.shape[0] > 0)
    fields = ByteTrackConfig.__dataclass_fields__
    btc = ByteTrackConfig(**{k: v for k, v in raw.items() if k in fields})
    xyxy = cxcywh_to_xyxy(torch.as_tensor(np.asarray(boxes_cxcywh,
                                                     np.float32), device=dev))
    motion = None
    if use_gmc:
        flow = np.asarray(flow)
        gy, gx = motion_grid(*flow.shape[-2:])
        pts = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        samples = flow[:, :, gy, gx].reshape(flow.shape[0], 2, -1)
        motion = fit_global_motion(
            torch.as_tensor(pts, device=dev),
            torch.as_tensor(np.ascontiguousarray(samples.transpose(0, 2, 1)),
                            device=dev))
    ids = track_sequence_ids(xyxy, np.asarray(scores, np.float32),
                             np.asarray(valid, bool), btc, motion=motion)
    return ids.cpu().numpy()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def load_variables(cfg, key: str):
    """The skix variables (nested dicts of numpy arrays) of the npz that
    ``cfg[key]`` names, or None when the key is unset or the file is
    missing (smoke mode, logged). A torch checkpoint raises: it needs the
    converter that :data:`CONVERTERS` names."""
    ckpt = cfg.get(key)
    if not (ckpt and Path(ckpt).exists()):
        log.warning("%s not configured — random init (smoke mode)", key)
        return None
    p = Path(ckpt)
    if p.suffix in (".bin", ".pth", ".pt"):
        raise ValueError(
            f"{key}={p} is a torch checkpoint; convert it offline with "
            f"{CONVERTERS.get(key, 'its converter')} and save the skix npz")
    from skix_torch.convert import load_flat_npz

    out: dict = {}
    for k, v in load_flat_npz(p).items():
        node = out
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _model(cfg, key: str, build: Callable, seed: int, device, extra=()):
    """The model ``build()`` with the weights of ``cfg[key]`` (or seeded
    flax-distributed ones), on ``device``, in eval mode; built once per
    (key, checkpoint, ``extra`` — the model's shape arguments —, device)."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models.layers import init_like_flax

    cache_key = (key, str(cfg.get(key)), tuple(extra), str(device))
    if cache_key in _MODELS:
        return _MODELS[cache_key]
    model = build()
    variables = load_variables(cfg, key)
    if variables is None:
        gen = torch.Generator().manual_seed(seed)
        if hasattr(model, "init_weights"):
            model.init_weights(gen)
        else:
            init_like_flax(model, gen)
    else:
        load_into(model, flax_to_state_dict(variables))
    model = model.to(device).eval()
    _MODELS[cache_key] = model
    return model


# ---------------------------------------------------------------------------
# the models of the skix backend
# ---------------------------------------------------------------------------

def _pad32(H: int, W: int):
    return (-H) % 32, (-W) % 32


def _detect_clip_yolo(cfg, frames, device):
    """Whole-clip YoloPose detection → padded (T, K, …) arrays."""
    from skix_torch.models.yolo_pose import YoloPose, detect

    scale = str(cfg.get("yolo_scale", "s"))
    version = int(cfg.get("yolo_version", 11))
    model = _model(cfg, "yolo_checkpoint",
                   lambda: YoloPose(scale=scale, version=version), 0, device,
                   (scale, version))
    top_k = int(cfg.get("top_k", 8))
    thr = float(cfg.get("score_threshold", 0.3))

    def detect_chunk(chunk):
        det = detect(model(chunk), top_k=top_k, score_threshold=thr)
        return det.boxes_xyxy, det.keypoints, det.valid, det.scores

    return _chunked_clip_detect(frames, int(cfg.get("det_batch", 8)),
                                _pad32(*frames.shape[1:3]), detect_chunk,
                                device)


def _detect_clip_boxes(cfg, frames, device):
    """Whole-clip plain-Detect person boxes (ultralytics' ``classes=0``)
    → cxcywh boxes, class ids, valid, scores."""
    from skix_torch.models.yolo_pose import YoloDetect, detect_boxes

    scale = str(cfg.get("bbox_scale", cfg.get("yolo_scale", "s")))
    nc = int(cfg.get("bbox_classes", 80))
    version = int(cfg.get("yolo_version", 11))
    model = _model(cfg, "bbox_checkpoint",
                   lambda: YoloDetect(scale=scale, num_classes=nc,
                                      version=version), 4, device,
                   (scale, nc, version))
    top_k = int(cfg.get("top_k", 8))
    thr = float(cfg.get("bbox_score_threshold",
                        cfg.get("score_threshold", 0.3)))

    def detect_chunk(chunk):
        det = detect_boxes(model(chunk), top_k=top_k, score_threshold=thr,
                           classes=(0,))
        return det.boxes_xyxy, det.cls, det.valid, det.scores

    return _chunked_clip_detect(frames, int(cfg.get("det_batch", 8)),
                                _pad32(*frames.shape[1:3]), detect_chunk,
                                device)


def _detect_clip_seg(cfg, frames, device):
    """Whole-clip YoloSeg person segmentation → (T, K, 4) cxcywh boxes,
    (T, K, Hp, Wp) mask probabilities on the stride-4 grid of the padded
    frame, (T, K) valid, scores."""
    from skix_torch.models.yolo_pose import YoloSeg, detect_seg

    scale = str(cfg.get("seg_scale", cfg.get("yolo_scale", "s")))
    version = int(cfg.get("yolo_version", 11))
    model = _model(cfg, "seg_checkpoint",
                   lambda: YoloSeg(scale=scale, version=version), 3, device,
                   (scale, version))
    top_k = int(cfg.get("top_k", 8))
    thr = float(cfg.get("seg_score_threshold",
                        cfg.get("score_threshold", 0.3)))

    def detect_chunk(chunk):
        det = detect_seg(model(chunk), top_k=top_k, score_threshold=thr)
        return det.boxes_xyxy, det.masks, det.valid, det.scores

    return _chunked_clip_detect(frames, int(cfg.get("det_batch", 8)),
                                _pad32(*frames.shape[1:3]), detect_chunk,
                                device)


def _detect_clip_rcnn(cfg, frames, device):
    """Whole-clip KeypointRCNN detection (the D2 source) → padded arrays
    in the same contract."""
    from skix_torch.models.keypoint_rcnn import KeypointRCNN

    kw = dict(pre_nms_topk=int(cfg.get("d2_pre_nms_topk", 256)),
              post_nms_topk=int(cfg.get("d2_post_nms_topk", 64)),
              detections=int(cfg.get("top_k", 8)),
              score_threshold=float(cfg.get("d2_score_threshold", 0.7)))
    if not cfg.get("d2_checkpoint"):
        log.warning("random-init KeypointRCNN is smoke-only")
    model = _model(cfg, "d2_checkpoint", lambda: KeypointRCNN(**kw), 1,
                   device, tuple(sorted(kw.items())))

    def detect_chunk(chunk):
        out = model(chunk)
        return out.boxes_xyxy, out.keypoints, out.valid, out.scores

    return _chunked_clip_detect(frames, int(cfg.get("d2_batch", 2)),
                                _pad32(*frames.shape[1:3]), detect_chunk,
                                device)


def _depth_task(cfg, frames, device) -> np.ndarray:
    """(T, 1, H, W) depth: the frames cropped to /16, the DPT forward in
    ``depth_batch`` chunks, the depth edge-padded back to H × W."""
    from skix_torch.models.dpt import MonocularDepth, estimate_depth_batched

    H, W = frames.shape[1:3]
    n_layers = int(cfg.get("depth_layers", 12))
    # 4 evenly spaced taps over the configured depth
    taps = tuple(sorted({max(0, (n_layers * (i + 1)) // 4 - 1)
                         for i in range(4)}))
    while len(taps) < 4:  # tiny configs: pad with the last layer
        taps = taps + (n_layers - 1,)
    hw = ((H // 16) * 16, (W // 16) * 16)
    kw = dict(patch_size=16, embed_dim=int(cfg.get("depth_dim", 384)),
              depth=n_layers, num_heads=int(cfg.get("depth_heads", 6)),
              taps=taps, features=int(cfg.get("depth_features", 256)),
              image_hw=hw)
    model = _model(cfg, "depth_checkpoint", lambda: MonocularDepth(**kw), 1,
                   device, tuple(sorted(kw.items())))
    d = estimate_depth_batched(model, frames[:, :hw[0], :hw[1]],
                               batch_size=int(cfg.get("depth_batch", 4)),
                               device=device)
    return np.pad(d, ((0, 0), (0, 0), (0, H - d.shape[2]),
                      (0, W - d.shape[3])), mode="edge")


def _flow_task(cfg, frames, device) -> np.ndarray:
    from skix_torch.models.raft import RAFT, compute_flow_sequence

    kw = dict(hidden=int(cfg.get("flow_hidden", 96)),
              context=int(cfg.get("flow_context", 64)), corr_levels=3,
              corr_radius=3, iters=int(cfg.get("flow_iters", 8)))
    model = _model(cfg, "flow_checkpoint", lambda: RAFT(**kw), 2, device,
                   tuple(sorted(kw.items())))
    return compute_flow_sequence(model, frames,
                                 chunk_size=int(cfg.get("flow_batch", 2)),
                                 device=device)


def _compact_detect(cfg, frames, device):
    from skix_torch.models.pose_detector import PoseDetector, detect_clip

    kw = dict(width=int(cfg.get("detector_width", 64)),
              depth=int(cfg.get("detector_depth", 4)),
              top_k=int(cfg.get("top_k", 8)),
              score_threshold=float(cfg.get("score_threshold", 0.3)))
    model = _model(cfg, "detector_checkpoint", lambda: PoseDetector(**kw), 0,
                   device, tuple(sorted(kw.items())))
    return detect_clip(model, frames, batch_size=int(cfg.get("det_batch", 8)),
                       device=device)


@register_backend("skix")
def _skix_backend(cfg, video_path: Path):
    """The perception models on the stage's device: the primary
    (YOLO-slot) source by ``pose_model``, the optional bbox, mask, D2,
    depth and flow tasks, then ByteTrack ids (after the flow task, so that
    ``botsort`` fits camera motion on it)."""
    device = _stage_device(cfg)
    tasks = set(cfg.get("tasks", ["pose"]))
    pose_model = str(cfg.get("pose_model", "compact"))
    d2_model = str(cfg.get("d2_model", "none"))

    @torch.no_grad()
    def run(frames: np.ndarray) -> dict:
        # the clip goes to the device once, as uint8
        frames_dev = torch.as_tensor(frames, device=device)
        if pose_model == "yolo":
            boxes, kpts, valid, scores = _detect_clip_yolo(cfg, frames_dev,
                                                           device)
        else:
            boxes, kpts, valid, scores = _compact_detect(cfg, frames_dev,
                                                         device)
        out = {"boxes": boxes, "keypoints": kpts, "det_valid": valid}
        if str(cfg.get("bbox_model", "none")) == "detect":
            bb, _, bv, bs = _detect_clip_boxes(cfg, frames_dev, device)
            out.update({"bbox_boxes": bb, "bbox_valid": bv,
                        "bbox_scores": bs})
        if "mask" in tasks:
            sb, sm, sv, _ = _detect_clip_seg(cfg, frames_dev, device)
            out.update({"seg_boxes": sb, "seg_masks": sm, "seg_valid": sv})
        if d2_model == "rcnn":
            d2b, d2k, d2v, _ = _detect_clip_rcnn(cfg, frames_dev, device)
            out.update({"d2_boxes": d2b, "d2_keypoints": d2k,
                        "d2_det_valid": d2v})
        if "depth" in tasks:
            out["depth"] = _depth_task(cfg, frames_dev, device)
        if "optical_flow" in tasks:
            out["optical_flow"] = _flow_task(cfg, frames_dev, device)
        del frames_dev
        if bool(cfg.get("tracking", True)) and frames.shape[0]:
            out["track_ids"] = _compute_track_ids(
                cfg, boxes, scores, valid, flow=out.get("optical_flow"),
                device=device)
            if "bbox_boxes" in out:
                out["bbox_track_ids"] = _compute_track_ids(
                    cfg, out["bbox_boxes"], out["bbox_scores"],
                    out["bbox_valid"], flow=out.get("optical_flow"),
                    device=device)
        return out

    return run


# ---------------------------------------------------------------------------
# selection, filling and the mask slot
# ---------------------------------------------------------------------------

def _select_and_fill(det: dict, device) -> dict:
    """Athlete selection + hole filling on raw padded detections;
    ``track_ids`` (ByteTrack's det→id map) engage selection priority 1,
    −1s otherwise."""
    from skix_torch.perception.selection import (fill_invalid_frames,
                                                 select_person_sequence)

    valid = np.asarray(det["det_valid"], bool)
    tid = det.get("track_ids")
    if tid is None:
        tid = np.full(valid.shape, -1, np.int32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    sel = select_person_sequence(t(det["boxes"], np.float32),
                                 t(det["keypoints"], np.float32),
                                 det_valid=t(valid, bool),
                                 track_ids=t(tid, np.int32))
    kp = fill_invalid_frames(sel.keypoints, sel.valid).cpu().numpy()
    sc = fill_invalid_frames(sel.scores, sel.valid).cpu().numpy()
    bx = fill_invalid_frames(sel.boxes, sel.valid).cpu().numpy()
    none_index = np.where(sel.none_index.cpu().numpy())[0].astype(np.int64)
    xyxy = np.stack([bx[:, 0] - bx[:, 2] / 2, bx[:, 1] - bx[:, 3] / 2,
                     bx[:, 0] + bx[:, 2] / 2, bx[:, 1] + bx[:, 3] / 2], -1)
    kpts3 = np.concatenate([kp, sc[..., None]], axis=-1)
    return {"keypoints": kpts3.astype(np.float32),
            "scores": sc.astype(np.float32),
            "bbox": xyxy.astype(np.float32),
            "none_index": none_index}


def _padded_hw(H: int, W: int):
    # the seg masks live on the stride-4 grid of the /32-padded frame
    return (H + (-H) % 32, W + (-W) % 32)


def _assemble_person_mask(det: dict, H: int, W: int, device,
                          chunk: int = 32) -> np.ndarray:
    """(T, 1, H, W) uint8 athlete mask: selection on the seg model's own
    boxes, the chosen slot's proto-grid probabilities hole-filled, then a
    chunked bilinear upsample (jax's resize) to the padded frame and a 0.5
    threshold (ultralytics' order: upsample before the threshold)."""
    from skix_torch.perception.selection import (fill_invalid_frames,
                                                 select_person_sequence)
    from skix_torch.utils.image import resize

    boxes = torch.as_tensor(np.asarray(det["seg_boxes"], np.float32),
                            device=device)
    valid = torch.as_tensor(np.asarray(det["seg_valid"], bool), device=device)
    T, K = boxes.shape[:2]
    sel = select_person_sequence(
        boxes, torch.zeros((T, K, 1, 2), device=device), det_valid=valid)
    masks = torch.as_tensor(np.asarray(det["seg_masks"], np.float32),
                            device=device)
    m = fill_invalid_frames(masks[torch.arange(T, device=device),
                                  sel.sel_idx], sel.valid)
    out = np.zeros((T, 1, H, W), np.uint8)
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        up = resize(m[s:e], (e - s, *_padded_hw(H, W)), "bilinear")
        out[s:e, 0] = (up[:, :H, :W] > 0.5).to(torch.uint8).cpu().numpy()
    return out


def process_video(cfg, video_path: Path, out_path: Path) -> PTInfo:
    meta = probe_video(video_path)
    chunks = list(read_video_chunks(video_path,
                                    chunk_size=int(cfg.get("chunk_size", 64)),
                                    max_frames=cfg.get("max_frames")))
    frames = (np.concatenate(chunks, 0) if chunks
              else np.zeros((0, meta.height, meta.width, 3), np.uint8))
    T = frames.shape[0]
    device = _stage_device(cfg)

    backend = _BACKENDS[str(cfg.get("backend", "precomputed"))](cfg,
                                                                video_path)
    det = backend(frames)
    sel = _select_and_fill(det, device)
    if "bbox_boxes" in det and T:
        # the bbox slot from the separate detect run, with its own picking
        K = det["bbox_boxes"].shape[1]
        sel_bbox = _select_and_fill({
            "boxes": det["bbox_boxes"],
            "keypoints": np.zeros((T, K, 1, 2), np.float32),
            "det_valid": det["bbox_valid"],
            "track_ids": det.get("bbox_track_ids")}, device)
        sel = dict(sel, bbox=sel_bbox["bbox"])
    # the second, independent 2D source
    if "d2_boxes" in det:
        sel_d2 = _select_and_fill({"boxes": det["d2_boxes"],
                                   "keypoints": det["d2_keypoints"],
                                   "det_valid": det["d2_det_valid"]}, device)
    else:
        sel_d2 = sel

    yolo_mask = None
    if "seg_masks" in det and T:
        yolo_mask = _assemble_person_mask(det, frames.shape[1],
                                          frames.shape[2], device)

    info = PTInfo(
        video_name=video_path.stem,
        video_path=str(video_path),
        frame_count=T,
        img_shape=(frames.shape[1], frames.shape[2]),
        fps=meta.fps,
        duration=T / meta.fps if meta.fps else 0.0,
        frames=frames if bool(cfg.get("store_frames", False)) else None,
        depth=det.get("depth"),
        optical_flow=det.get("optical_flow"),
        yolo_mask=yolo_mask,
        none_index=sel["none_index"],
        yolo_bbox=sel["bbox"],
        yolo_keypoints=sel["keypoints"],
        yolo_keypoints_score=sel["scores"],
        d2_bbox=sel_d2["bbox"],
        d2_keypoints=sel_d2["keypoints"],
        d2_keypoints_score=sel_d2["scores"],
    )
    check_pt_info_shapes(info)
    save_pt_info(out_path, info)
    return info


@cli_main("prepare_dataset")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    root = Path(cfg.paths.video_root)
    out_root = Path(cfg.paths.out_root)
    done, failed, skipped = 0, 0, 0
    for person_dir in iter_person_dirs(root, cfg):
        for video in sorted(person_dir.glob("*.mp4")):
            out_path = out_root / person_dir.name / f"{video.stem}.npz"
            if out_path.exists() and not bool(cfg.get("overwrite", False)):
                skipped += 1
                continue
            try:
                process_video(cfg, video, out_path)
                done += 1
                log.info("processed %s/%s", person_dir.name, video.name)
            except Exception:  # noqa: BLE001 — per-video isolation
                failed += 1
                log.exception("video %s failed", video)
    log.info("prepare_dataset: %d done, %d skipped, %d failed",
             done, skipped, failed)


if __name__ == "__main__":
    main()
