"""Box-track lifecycle over fixed-capacity object slots.

Port of ``skix/tracking/lifecycle.py``: a struct-of-arrays state of
``max_objects`` slots; each frame's update is a pure function of (state,
detections): greedy max-IoU association in ``min(K, N)`` fixed rounds,
momentum box update, keep-alive decay, confirmation after
``min_hits_to_confirm`` hits, duplicate suppression (the lower keep-alive,
then the higher slot, loses), and spawning of unmatched confident
detections into free slots in rank order. Tensor ops on the state's
device, no host reads: ids, hits and confirmations equal skix's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from skix_torch.ops.nms import box_iou

_NEG = -1e9


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_objects: int = 16          # fixed slot capacity
    iou_match_threshold: float = 0.3
    det_score_threshold: float = 0.5   # min score to spawn a track
    keep_alive_decay: float = 0.9      # unmatched decay (keep-alive score)
    keep_alive_min: float = 0.2        # kill below this
    max_time_since_update: int = 12    # occlusion tolerance (frames)
    min_hits_to_confirm: int = 3       # hotstart delay before "confirmed"
    duplicate_iou_threshold: float = 0.7
    bbox_momentum: float = 0.7         # matched-box EMA (1 = replace)


class TrackerState(NamedTuple):
    active: torch.Tensor       # (K,) bool
    confirmed: torch.Tensor    # (K,) bool
    bbox: torch.Tensor         # (K, 4) xyxy
    score: torch.Tensor        # (K,)
    keep_alive: torch.Tensor   # (K,)
    hits: torch.Tensor         # (K,) int32
    age: torch.Tensor          # (K,) int32
    missing: torch.Tensor      # (K,) int32 frames since the last match
    obj_id: torch.Tensor       # (K,) int32 stable ids (−1 = free slot)
    next_id: torch.Tensor      # () int32 next id to assign


def init_tracker_state(cfg: TrackerConfig, device=None) -> TrackerState:
    K = cfg.max_objects
    i32 = dict(dtype=torch.int32, device=device)
    return TrackerState(
        active=torch.zeros(K, dtype=torch.bool, device=device),
        confirmed=torch.zeros(K, dtype=torch.bool, device=device),
        bbox=torch.zeros((K, 4), device=device),
        score=torch.zeros(K, device=device),
        keep_alive=torch.zeros(K, device=device),
        hits=torch.zeros(K, **i32), age=torch.zeros(K, **i32),
        missing=torch.zeros(K, **i32), obj_id=torch.full((K,), -1, **i32),
        next_id=torch.zeros((), **i32))


def _greedy_match(iou, track_ok, det_ok, thresh: float, rounds: int):
    """Greedy max-IoU assignment in ``rounds`` fixed rounds: track → det
    index or −1 (ties to the first flat index, as ``jnp.argmax``)."""
    K, N = iou.shape
    masked = torch.where(track_ok[:, None] & det_ok[None, :], iou,
                         torch.full_like(iou, _NEG))
    assign = torch.full((K,), -1, dtype=torch.int32, device=iou.device)
    for _ in range(rounds):
        flat = torch.argmax(masked)
        ti, di = flat // N, flat % N
        take = masked[ti, di] >= thresh
        assign = torch.where(take & (torch.arange(K, device=iou.device) == ti),
                             di.to(torch.int32), assign)
        cut = ((torch.arange(K, device=iou.device) == ti)[:, None]
               | (torch.arange(N, device=iou.device) == di)[None, :])
        masked = torch.where(take & cut, torch.full_like(masked, _NEG), masked)
    return assign


def tracker_step(state: TrackerState, det_boxes, det_scores, det_valid,
                 cfg: TrackerConfig):
    """One frame: associate → update → suppress duplicates → spawn.
    ``det_boxes (N, 4)``, ``det_scores (N,)``, ``det_valid (N,)`` bool on
    the state's device. Returns ``(new_state, frame_output)``, the output
    mirroring the slot state after the update."""
    K = cfg.max_objects
    dev = state.bbox.device
    det_ok = det_valid.to(torch.bool) & (det_scores > 0)
    N = det_boxes.shape[0]

    iou = box_iou(state.bbox, det_boxes)
    assign = _greedy_match(iou, state.active, det_ok,
                           cfg.iou_match_threshold, rounds=min(K, N))
    matched = assign >= 0
    safe = torch.clamp(assign, min=0).to(torch.int64)
    new_box, new_score = det_boxes[safe], det_scores[safe]

    m = cfg.bbox_momentum
    bbox = torch.where(matched[:, None], m * new_box + (1 - m) * state.bbox,
                       state.bbox)
    score = torch.where(matched, new_score, state.score)
    keep_alive = torch.where(matched,
                             torch.maximum(state.keep_alive, new_score),
                             state.keep_alive * cfg.keep_alive_decay)
    hits = torch.where(matched, state.hits + 1, state.hits)
    missing = torch.where(matched, torch.zeros_like(state.missing),
                          state.missing + 1)
    age = torch.where(state.active, state.age + 1, state.age)
    confirmed = state.confirmed | (hits >= cfg.min_hits_to_confirm)
    alive = (state.active & (missing <= cfg.max_time_since_update)
             & (keep_alive >= cfg.keep_alive_min))

    # duplicate suppression among surviving tracks: the lower keep-alive
    # of an overlapping pair dies (the higher slot on a tie)
    overlap = ((box_iou(bbox, bbox) > cfg.duplicate_iou_threshold)
               & ~torch.eye(K, dtype=torch.bool, device=dev))
    both = alive[:, None] & alive[None, :]
    ka_i, ka_j = keep_alive[:, None], keep_alive[None, :]
    idx = torch.arange(K, device=dev)
    loses = overlap & both & ((ka_i < ka_j) | ((ka_i == ka_j)
                                               & (idx[:, None] > idx[None, :])))
    alive = alive & ~loses.any(dim=1)

    # spawn: unmatched confident detections into free slots, rank by rank
    det_taken = torch.zeros(N, dtype=torch.int32, device=dev).index_put(
        (safe,), matched.to(torch.int32), accumulate=True) > 0
    spawnable = det_ok & ~det_taken & (det_scores > cfg.det_score_threshold)
    free = ~alive
    det_rank = torch.cumsum(spawnable.to(torch.int32), 0) - 1
    slot_rank = torch.where(free, torch.cumsum(free.to(torch.int32), 0) - 1,
                            torch.full((K,), K + 1, device=dev))
    pair = (det_rank[None, :] == slot_rank[:, None]) & spawnable[None, :]
    det_for_slot = torch.argmax(pair.to(torch.int32), dim=1)
    spawn = free & pair.any(dim=1)
    sd = det_for_slot
    bbox = torch.where(spawn[:, None], det_boxes[sd], bbox)
    score = torch.where(spawn, det_scores[sd], score)
    keep_alive = torch.where(spawn, det_scores[sd], keep_alive)
    one = torch.ones_like(hits)
    hits = torch.where(spawn, one, torch.where(alive, hits,
                                               torch.zeros_like(hits)))
    missing = torch.where(spawn, torch.zeros_like(missing), missing)
    age = torch.where(spawn, one, age)
    confirmed = torch.where(
        spawn, torch.full_like(confirmed, cfg.min_hits_to_confirm <= 1),
        confirmed & alive)
    new_ids = (state.next_id + torch.cumsum(spawn.to(torch.int32), 0)
               - 1).to(torch.int32)
    obj_id = torch.where(spawn, new_ids,
                         torch.where(alive, state.obj_id,
                                     torch.full_like(state.obj_id, -1)))
    active = alive | spawn

    new_state = TrackerState(
        active=active, confirmed=confirmed, bbox=bbox, score=score,
        keep_alive=keep_alive, hits=hits, age=age, missing=missing,
        obj_id=obj_id,
        next_id=(state.next_id + spawn.to(torch.int32).sum()).to(torch.int32))
    out = {"active": active, "confirmed": confirmed, "bbox": bbox,
           "score": score, "obj_id": obj_id, "keep_alive": keep_alive}
    return new_state, out


def track_sequence(det_boxes, det_scores, det_valid,
                   cfg: TrackerConfig = TrackerConfig()):
    """Whole-clip tracking: ``det_boxes (T, N, 4)``, ``det_scores (T, N)``,
    ``det_valid (T, N)`` → per-frame slot outputs (dict of (T, K, ...))."""
    state = init_tracker_state(cfg, det_boxes.device)
    outs = []
    for t in range(det_boxes.shape[0]):
        state, out = tracker_step(state, det_boxes[t], det_scores[t],
                                  det_valid[t], cfg)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
