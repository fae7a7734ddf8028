"""Masklet (mask-level) video propagation: the SAM3 video model.

Port of ``skix/tracking/masklet.py`` (inference, text prompts): per frame,
detector masks → score-ranked detection slots → det↔track mask-IoU
association → keep-alive / hotstart / duplicate bookkeeping → occlusion,
pixel non-overlap and shrink suppression → spawns into free object slots →
memory-conditioned per-object propagation and memory writes.

The lifecycle stays a fixed-shape function over K object slots
(``MaskletState``, one tensor per field). skix ``vmap``s the object slots
and scans chunks of frames inside one jitted program; here the slots are a
batch axis (:mod:`skix_torch.tracking.memory_tracker`), ``lax.cond``/
``where`` become tensor selects, and the frame loop is a Python loop with
the same per-frame outputs. skix's bit-packing of the upsampled masks was
a transfer trick of its TPU host link; the port produces the same bool
array directly.

With ``fill_holes`` the detection and tracker mask logits of each frame
pass through :func:`skix_torch.ops.masks.fill_holes_in_mask_scores` before
the lifecycle, as in skix. A frame with point or box prompts
(``MaskletVideoModel.step(geometry=...)``, ``propagate(geometry_by_frame=
...)``) runs its detector call with them; every other frame runs as
without. :func:`track_masklets` runs the lifecycle over a clip's
detections alone, each slot carrying its last matched detection's mask.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from skix_torch.ops.masks import (fill_holes_in_mask_scores, mask_iou,
                                  masks_to_boxes)
from skix_torch.tracking.memory_tracker import (MemoryBank, init_memory,
                                                write_conditioning,
                                                write_recent)
from skix_torch.utils.image import resize

NO_OBJ_LOGIT = -10.0
_NEVER_OCCLUDED = -1
_ALWAYS_OCCLUDED = 1 << 20
_BIG = 1 << 20


@dataclasses.dataclass(frozen=True)
class MaskletConfig:
    """The reference's ``Sam3VideoBase`` knobs with skix's defaults, plus
    the fixed slot/detection capacities."""

    max_objects: int = 16
    max_dets: int = 16
    score_threshold_detection: float = 0.5
    det_nms_thresh: float = 0.0
    assoc_iou_thresh: float = 0.5
    trk_assoc_iou_thresh: float = 0.5
    new_det_thresh: float = 0.5
    hotstart_delay: int = 0
    hotstart_unmatch_thresh: int = 3
    hotstart_dup_thresh: int = 3
    suppress_unmatched_only_within_hotstart: bool = True
    init_trk_keep_alive: int = 0
    max_trk_keep_alive: int = 8
    min_trk_keep_alive: int = -4
    occlusion_suppress_iou: float = 0.0
    decrease_keep_alive_for_empty: bool = False
    confirmation_consecutive_det: int = 3
    shrink_suppress_ratio: float = 0.3
    fill_hole_area: int = 16
    dense_memory_attention: bool = True
    reverse: bool = False


class MaskletState(NamedTuple):
    """Fixed-capacity struct-of-arrays masklet bookkeeping (K slots)."""

    active: torch.Tensor           # (K,) bool
    obj_id: torch.Tensor           # (K,) int32, −1 = free slot
    spawn_score: torch.Tensor      # (K,) f32
    first_frame: torch.Tensor      # (K,) int32
    keep_alive: torch.Tensor       # (K,) int32
    unmatched_count: torch.Tensor  # (K,) int32
    consec_det: torch.Tensor       # (K,) int32
    confirmed: torch.Tensor        # (K,) bool
    last_occluded: torch.Tensor    # (K,) int32
    overlap_count: torch.Tensor    # (K, K) int32
    frame_idx: torch.Tensor        # () int32
    next_id: torch.Tensor          # () int32


def init_masklet_state(cfg: MaskletConfig, start_frame: int = 0,
                       device=None) -> MaskletState:
    K = cfg.max_objects
    i32 = dict(dtype=torch.int32, device=device)
    return MaskletState(
        active=torch.zeros(K, dtype=torch.bool, device=device),
        obj_id=torch.full((K,), -1, **i32),
        spawn_score=torch.zeros(K, device=device),
        first_frame=torch.zeros(K, **i32),
        keep_alive=torch.zeros(K, **i32),
        unmatched_count=torch.zeros(K, **i32),
        consec_det=torch.zeros(K, **i32),
        confirmed=torch.zeros(K, dtype=torch.bool, device=device),
        last_occluded=torch.full((K,), _NEVER_OCCLUDED, **i32),
        overlap_count=torch.zeros((K, K), **i32),
        frame_idx=torch.tensor(start_frame, **i32),
        next_id=torch.tensor(0, **i32))


def masklet_update(state: MaskletState, trk_mask_logits, det_mask_logits,
                   det_scores, det_valid, cfg: MaskletConfig):
    """One frame of masklet lifecycle: associate → bookkeep → suppress →
    spawn. ``trk_mask_logits (K, h, w)`` per-slot propagated logits (gated
    by ``active``); ``det_mask_logits (N, h, w)``, ``det_scores (N,)``
    post-sigmoid, ``det_valid (N,)``. Returns ``(new_state, out)``."""
    K = cfg.max_objects
    N = det_mask_logits.shape[0]
    dev = trk_mask_logits.device
    i32 = torch.int32
    ar = torch.arange(K, device=dev)
    frame_idx = state.frame_idx
    active = state.active
    det_valid = det_valid.to(torch.bool)

    trk_bin = (trk_mask_logits > 0) & active[:, None, None]
    det_bin = (det_mask_logits > 0) & det_valid[:, None, None]
    pair_ok = det_valid[:, None] & active[None, :]
    iou = torch.where(pair_ok, mask_iou(det_bin, trk_bin), 0.0)   # (N, K)

    trk_nonempty = trk_bin.flatten(1).any(dim=1)
    trk_matched_strict = (iou >= cfg.trk_assoc_iou_thresh).any(dim=0)
    unmatched = active & trk_nonempty & ~trk_matched_strict
    empty_trk = active & ~trk_nonempty
    M = (iou >= cfg.assoc_iou_thresh) & pair_ok                   # (N, K)
    trk_matched_loose = M.any(dim=0)

    # keep-alive
    ka = state.keep_alive
    ka = torch.where(trk_matched_loose,
                     torch.clamp(ka + 1, max=cfg.max_trk_keep_alive), ka)
    ka = torch.where(unmatched,
                     torch.clamp(ka - 1, min=cfg.min_trk_keep_alive), ka)
    if cfg.decrease_keep_alive_for_empty:
        ka = torch.where(empty_trk,
                         torch.clamp(ka - 1, min=cfg.min_trk_keep_alive), ka)
    unmatched_count = state.unmatched_count + unmatched.to(i32)

    is_new = det_valid & (det_scores >= cfg.new_det_thresh) & ~M.any(dim=1)

    # hotstart removal: unmatched too long within the window
    if cfg.reverse:
        within = state.first_frame < frame_idx + cfg.hotstart_delay
    else:
        within = state.first_frame > frame_idx - cfg.hotstart_delay
    removed_unmatch = active & within & (
        unmatched_count >= cfg.hotstart_unmatch_thresh)

    # duplicates: pairs of tracks matched to one detection
    dup_det = det_valid & (M.sum(dim=1) >= 2)
    ff_key = -state.first_frame if cfg.reverse else state.first_frame
    slot_key = torch.where(M, ff_key[None, :] * K + ar[None, :], _BIG)
    earliest = torch.argmin(slot_key, dim=1)                      # (N,)
    pair_inc = (dup_det[:, None, None] & M[:, None, :]
                & (earliest[:, None, None] == ar[None, :, None])
                & (ar[None, :, None] != ar[None, None, :])).any(dim=0)
    overlap_count = state.overlap_count + pair_inc.to(i32)
    removed_dup = active & within & (
        overlap_count >= cfg.hotstart_dup_thresh).any(dim=0)

    removed = removed_unmatch | removed_dup
    alive = active & ~removed

    ka_suppressed = torch.zeros(K, dtype=torch.bool, device=dev)
    if not cfg.suppress_unmatched_only_within_hotstart:
        ka_suppressed = alive & (ka <= 0) & (unmatched_count >= 1)

    # occlusion suppression of overlapping propagated masks
    occ_suppressed = torch.zeros(K, dtype=torch.bool, device=dev)
    if cfg.occlusion_suppress_iou > 0.0:
        locc = torch.where(removed, _ALWAYS_OCCLUDED, state.last_occluded)
        tiou = mask_iou(trk_bin, trk_bin)
        both = (active[:, None] & active[None, :]
                & ~torch.eye(K, dtype=torch.bool, device=dev))
        overlapping = (tiou >= cfg.occlusion_suppress_iou) & both
        recency = ((locc[:, None] < locc[None, :]) if cfg.reverse
                   else (locc[:, None] > locc[None, :]))
        loses = overlapping & recency & (locc[None, :] > _NEVER_OCCLUDED)
        occ_suppressed = loses.any(dim=1) & alive
    is_occluded = active & ~trk_nonempty
    last_occluded = torch.where(is_occluded | occ_suppressed, frame_idx,
                                state.last_occluded)

    trk_out = torch.where((occ_suppressed | ~active)[:, None, None],
                          NO_OBJ_LOGIT, trk_mask_logits)

    # memory-encoding masks: pixel non-overlap + shrink suppression
    part = torch.where(alive[:, None, None], trk_out, -torch.inf)
    winner = torch.argmax(part, dim=0)
    keep_px = winner[None] == ar[:, None, None]
    nonover = torch.where(keep_px, trk_out,
                          torch.clamp(trk_out, max=NO_OBJ_LOGIT))
    area_before = torch.clamp(
        (trk_out > 0).flatten(1).sum(dim=1).to(torch.float32), min=1.0)
    area_after = (nonover > 0).flatten(1).sum(dim=1).to(torch.float32)
    shrunk = alive & (area_after / area_before < cfg.shrink_suppress_ratio)
    mem_mask_logits = torch.where(shrunk[:, None, None],
                                  torch.clamp(trk_out, max=NO_OBJ_LOGIT),
                                  trk_out)

    # spawn score-ranked new detections into free slots
    order = torch.argsort(torch.where(is_new, -det_scores, torch.inf),
                          stable=True)
    ranks = torch.empty(N, dtype=torch.int64, device=dev)
    ranks[order] = torch.arange(N, device=dev)
    det_rank = torch.where(is_new, ranks, _BIG)
    free = ~alive
    free_rank = torch.where(free, torch.cumsum(free.to(torch.int64), 0) - 1,
                            _BIG + 1)
    hit = det_rank[None, :] == free_rank[:, None]                 # (K, N)
    spawn = free & hit.any(dim=1)
    spawn_det = torch.where(spawn, torch.argmax(hit.to(torch.int32), dim=1),
                            0)
    new_ids = state.next_id + torch.where(free_rank < K, free_rank, 0)

    obj_id = torch.where(spawn, new_ids,
                         torch.where(alive, state.obj_id, -1)).to(i32)
    spawn_score = torch.where(spawn, det_scores[spawn_det],
                              torch.where(alive, state.spawn_score, 0.0))
    first_frame = torch.where(spawn, frame_idx, state.first_frame)
    ka = torch.where(spawn, cfg.init_trk_keep_alive, ka)
    unmatched_count = torch.where(spawn, 0, unmatched_count)
    last_occluded = torch.where(spawn, _NEVER_OCCLUDED, last_occluded)

    # confirmation: consecutive matched frames, sticky status
    is_matched = spawn | (alive & trk_matched_loose)
    consec = torch.where(is_matched,
                         torch.where(spawn, 1, state.consec_det + 1),
                         0).to(i32)
    confirmed = ((state.confirmed & alive & ~spawn)
                 | (consec >= cfg.confirmation_consecutive_det))

    stale = spawn | (~alive & ~spawn)
    overlap_count = torch.where(stale[:, None] | stale[None, :], 0,
                                overlap_count)
    active_new = alive | spawn

    out_mask_logits = torch.where(
        spawn[:, None, None], det_mask_logits[spawn_det],
        torch.where((alive & ~ka_suppressed)[:, None, None], trk_out,
                    NO_OBJ_LOGIT))
    mem_mask_logits = torch.where(spawn[:, None, None],
                                  det_mask_logits[spawn_det], mem_mask_logits)

    best_det = torch.argmax(iou.T, dim=1)
    new_state = MaskletState(
        active=active_new, obj_id=obj_id, spawn_score=spawn_score,
        first_frame=first_frame.to(i32), keep_alive=ka.to(i32),
        unmatched_count=unmatched_count.to(i32), consec_det=consec,
        confirmed=confirmed, last_occluded=last_occluded.to(i32),
        overlap_count=overlap_count.to(i32),
        frame_idx=frame_idx + (-1 if cfg.reverse else 1),
        next_id=(state.next_id + spawn.sum()).to(i32))
    out = {
        "active": active_new, "obj_id": obj_id, "confirmed": confirmed,
        "spawn": spawn, "spawn_det": spawn_det, "removed": removed,
        "matched": alive & trk_matched_loose, "best_det": best_det,
        "out_mask_logits": out_mask_logits,
        "mem_mask_logits": mem_mask_logits,
        "ka_suppressed": ka_suppressed, "occ_suppressed": occ_suppressed,
        "spawn_score": spawn_score,
    }
    return new_state, out


# --------------------------------------------------------------------------
# full video model: Sam3Detector + MaskMemoryTracker + masklet lifecycle
# --------------------------------------------------------------------------
def track_masklets(det_mask_logits, det_scores, det_valid,
                   cfg: MaskletConfig = MaskletConfig()):
    """Whole-clip mask-IoU tracking without a memory tracker: each slot
    carries its last matched detection's mask as its propagated mask.
    ``det_mask_logits (T, N, h, w)``, ``det_scores (T, N)``, ``det_valid
    (T, N)`` → the per-frame slot outputs stacked over T (with ``boxes``,
    the xyxy boxes of the output masks on the grid)."""
    det_mask_logits = torch.as_tensor(det_mask_logits, dtype=torch.float32)
    det_scores = torch.as_tensor(det_scores, dtype=torch.float32,
                                 device=det_mask_logits.device)
    det_valid = torch.as_tensor(det_valid, dtype=torch.bool,
                                device=det_mask_logits.device)
    h, w = det_mask_logits.shape[-2:]
    state = init_masklet_state(cfg, device=det_mask_logits.device)
    carried = torch.full((cfg.max_objects, h, w), NO_OBJ_LOGIT,
                         device=det_mask_logits.device)
    outs = []
    for dm, ds, dv in zip(det_mask_logits, det_scores, det_valid):
        state, out = masklet_update(state, carried, dm, ds, dv, cfg)
        # the carried mask: the matched detection's, a spawn's own
        src = torch.where(out["spawn"], out["spawn_det"], out["best_det"])
        carried = torch.where((out["matched"] | out["spawn"])[:, None, None],
                              dm[src], carried)
        carried = torch.where(state.active[:, None, None], carried,
                              NO_OBJ_LOGIT)
        out["boxes"] = masks_to_boxes(out["out_mask_logits"] > 0)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _select_dets(det_boxes_cxcywh, det_score_logits, det_mask_logits,
                 cfg: MaskletConfig, out_hw):
    """Detector outputs (Q queries) → fixed N detection slots: sigmoid
    scores, optional box NMS, score-ranked top N (stable), masks resized
    bilinearly to the tracker's mask resolution."""
    scores = torch.sigmoid(det_score_logits)
    if cfg.det_nms_thresh > 0.0:
        from skix_torch.ops.nms import nms

        cx, cy, bw, bh = det_boxes_cxcywh.unbind(-1)
        xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                            cy + bh / 2], -1)
        keep = nms(xyxy, scores, iou_threshold=cfg.det_nms_thresh)
        scores = torch.where(keep, scores, 0.0)
    n = min(cfg.max_dets, scores.shape[0])
    order = torch.argsort(-scores, stable=True)[:n]
    sel_scores = scores[order]
    sel_masks = resize(det_mask_logits[order], (n, *out_hw), "bilinear")
    return (det_boxes_cxcywh[order], sel_scores, sel_masks,
            sel_scores > cfg.score_threshold_detection)


def _write_slots(bank: MemoryBank, enc, is_spawn, is_alive) -> MemoryBank:
    """Per object: a spawn resets its bank and pins ``enc`` as the
    conditioning memory (slot 0); a survivor writes ``enc`` into its recent
    ring; any other slot keeps its bank."""
    survived = write_recent(bank, enc)
    spawned = write_conditioning(MemoryBank(
        torch.zeros_like(bank.mem), torch.zeros_like(bank.valid),
        torch.ones_like(bank.ring_pos)), enc)

    def pick(a, b, c):
        s = is_spawn.reshape(-1, *[1] * (a.dim() - 1))
        k = (is_spawn | is_alive).reshape(s.shape)
        return torch.where(k, torch.where(s, a, b), c)

    return MemoryBank(*(pick(a, b, c)
                        for a, b, c in zip(spawned, survived, bank)))


def _masklet_frame_core(tracker, cfg: MaskletConfig, fill_holes: bool,
                        image_trk, det_boxes, det_score_logits,
                        det_mask_logits, state: MaskletState,
                        banks: MemoryBank):
    """One frame given the detector's outputs: tracker trunk → per-slot
    memory propagation (no write) → lifecycle → memory writes."""
    feats = tracker.encode_frame(image_trk)              # (1, gh, gw, C)
    gh, gw = feats.shape[1], feats.shape[2]
    trk_masks, trk_scores = tracker.attend_decode(
        feats, banks, cfg.dense_memory_attention)        # (K, gh, gw), (K,)
    det_boxes_sel, det_scores, det_masks, det_valid = _select_dets(
        det_boxes, det_score_logits, det_mask_logits, cfg, (gh, gw))
    if fill_holes and cfg.fill_hole_area > 0:
        det_masks = fill_holes_in_mask_scores(det_masks, cfg.fill_hole_area)
        trk_masks = fill_holes_in_mask_scores(
            torch.where(state.active[:, None, None], trk_masks,
                        torch.full_like(trk_masks, NO_OBJ_LOGIT)),
            cfg.fill_hole_area)
    new_state, out = masklet_update(state, trk_masks, det_masks, det_scores,
                                    det_valid, cfg)
    encoded = tracker.encode_memory(feats, out["mem_mask_logits"])
    banks = _write_slots(banks, encoded, out["spawn"],
                         out["active"] & ~out["spawn"])
    out["trk_scores"] = torch.sigmoid(trk_scores)
    out["boxes_lowres"] = masks_to_boxes(out["out_mask_logits"] > 0)
    out["det_boxes"] = det_boxes_sel
    return new_state, banks, out


def _prep_frame(frame, is_u8: bool, det_size: int, trk_size: int):
    """``(H, W, 3)`` uint8/float frame → (detector input, tracker input),
    each ``(1, size, size, 3)`` float32 as ``jax.image.resize`` bilinear."""
    img = frame.to(torch.float32)
    if is_u8:
        img = img / 255.0
    det_in = resize(img[None], (1, det_size, det_size, 3), "bilinear")
    tin = det_in if trk_size == det_size else resize(
        img[None], (1, trk_size, trk_size, 3), "bilinear")
    return det_in, tin


def _frame_outputs(out_hw, lowres_hw, mask, logits, boxes_lowres, obj_id,
                   active, confirmed, score, trk_score) -> dict:
    """The per-frame output dict; ``boxes_lowres`` are xyxy on the logits
    grid (``lowres_hw``) and scale to ``out_hw`` here."""
    lh, lw = lowres_hw
    boxes = np.array(boxes_lowres, np.float32)
    boxes[..., [0, 2]] *= out_hw[1] / lw
    boxes[..., [1, 3]] *= out_hw[0] / lh
    out = {"mask": np.asarray(mask), "boxes": boxes,
           "obj_id": np.asarray(obj_id), "active": np.asarray(active),
           "confirmed": np.asarray(confirmed), "score": np.asarray(score),
           "tracker_score": np.asarray(trk_score)}
    if logits is not None:
        out["mask_logits_lowres"] = np.asarray(logits)
    return out


class MaskletVideoModel:
    """The SAM3 video model: a promptable detector producing masks, a
    per-object mask-memory tracker and the masklet lifecycle. Both modules
    carry their weights and live on one device.

    ``timer`` (a :class:`skix_torch.utils.profiling.StageTimer`) times the
    ``detector`` and ``tracker`` parts of each frame and the ``outputs``
    (mask upsample + host copy); each span ends in a device synchronize."""

    def __init__(self, detector, tracker, cfg: MaskletConfig = MaskletConfig(),
                 fill_holes: bool = False, trk_img_size=None, timer=None):
        self.detector = detector
        self.tracker = tracker
        self.cfg = cfg
        self.fill_holes = fill_holes
        self.trk_img_size = trk_img_size or detector.img_size
        self.device = next(detector.parameters()).device
        self.timer = timer

    def _span(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.span(name, sync=self.device.type == "cuda")

    def init_state(self, trk_img_hw, start_frame: int = 0):
        """(state, banks) for a video at the tracker input resolution."""
        fh, fw = self.tracker.encoder.feature_hw(*trk_img_hw)
        banks = init_memory(self.tracker.mem_slots, fh, fw,
                            self.tracker.features, self.cfg.max_objects,
                            self.device)
        return (init_masklet_state(self.cfg, start_frame, self.device),
                banks)

    @torch.no_grad()
    def step(self, frame, prompt_tokens, state, banks, geometry=None,
             text_pad=None):
        """One frame: ``frame (H, W, 3)`` uint8/float, ``prompt_tokens
        (L, d_model)``; ``geometry``: optional point/box slots of this frame
        (the detector's keywords, each with a batch axis of 1, and the
        ``geometry_encoder`` to use where the detector has none). Returns
        (state, banks, outputs on the device)."""
        frame = torch.as_tensor(np.asarray(frame), device=self.device)
        with self._span("detector"):
            det_in, tin = _prep_frame(frame, frame.dtype == torch.uint8,
                                      self.detector.img_size,
                                      self.trk_img_size)
            det = self.detector(det_in, prompt_tokens[None],
                                None if text_pad is None else text_pad[None],
                                **(geometry or {}))
        with self._span("tracker"):
            return _masklet_frame_core(
                self.tracker, self.cfg, self.fill_holes, tin,
                det.boxes_cxcywh[0], det.scores[0], det.mask_logits[0],
                state, banks)

    def propagate(self, frames, prompt_tokens, yield_masks_at=None,
                  geometry_by_frame=None, include_lowres_logits: bool = True,
                  start_frame: int = 0, text_pad=None):
        """Yield ``{frame_index, outputs}`` over ``frames (T, H, W, 3)``:
        per-slot ``mask`` ((K, H', W') bool at ``yield_masks_at``, default
        the video size), ``boxes`` (xyxy at that size), ``obj_id``,
        ``active``, ``confirmed``, ``score`` (spawn detection score),
        ``tracker_score`` and, with ``include_lowres_logits``,
        ``mask_logits_lowres``. ``start_frame`` is the global index of
        ``frames[0]`` (the lifecycle counts down from it under
        ``cfg.reverse``). ``geometry_by_frame``: optional ``{t: geometry}``
        (:meth:`step`'s) for frames ``t`` of ``frames``."""
        geometry_by_frame = geometry_by_frame or {}
        T, H, W = frames.shape[:3]
        out_hw = (H, W) if yield_masks_at is None else tuple(yield_masks_at)
        prompt_tokens = torch.as_tensor(prompt_tokens, device=self.device)
        state, banks = self.init_state((self.trk_img_size,) * 2,
                                       start_frame=start_frame)
        for t in range(T):
            state, banks, out = self.step(frames[t], prompt_tokens, state,
                                          banks, geometry_by_frame.get(t),
                                          text_pad=text_pad)
            with self._span("outputs"):
                logits = out["out_mask_logits"]           # (K, gh, gw)
                masks = resize(logits, (logits.shape[0], *out_hw),
                               "bilinear") > 0
                host = [x.cpu().numpy() for x in (
                    masks, logits, out["boxes_lowres"], out["obj_id"],
                    out["active"], out["confirmed"], out["spawn_score"],
                    out["trk_scores"])]
            yield {"frame_index": t, "outputs": _frame_outputs(
                out_hw, tuple(logits.shape[-2:]), host[0],
                host[1] if include_lowres_logits else None, *host[2:])}

    def propagate_clip(self, frames, prompt_tokens, yield_masks_at=None,
                       chunk: int = 8, include_lowres_logits: bool = True,
                       start_frame: int = 0, text_pad=None):
        """skix's chunk-scanned propagation: the same per-frame outputs as
        :meth:`propagate` (``chunk`` was the frames per TPU dispatch and
        changes no result)."""
        del chunk
        return self.propagate(frames, prompt_tokens, yield_masks_at,
                              include_lowres_logits=include_lowres_logits,
                              start_frame=start_frame, text_pad=text_pad)
