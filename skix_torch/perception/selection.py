"""Single-athlete selection and missing-frame filling.

Port of ``skix/perception/selection.py``. Detections come as fixed-capacity
padded tensors ``(T, N, ...)`` with a validity mask. Selection walks the
frames in order carrying the previous centre and track id (skix's
``lax.scan``), with the same priorities: the detection holding the previous
frame's track id, else the one nearest the previous centre, else the
largest; every choice takes the lowest index on a tie (``argmax``/``argmin``
return the first extremum on both CPU and CUDA). The loop issues tensor ops
only, so on the card it queues work without waiting on it. Filling copies
the next valid frame into an invalid one, and the previous valid frame at
the tail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e9


class SelectedSequence(NamedTuple):
    keypoints: torch.Tensor   # (T, 17, 2)
    scores: torch.Tensor      # (T, 17)
    boxes: torch.Tensor       # (T, 4) cxcywh
    valid: torch.Tensor       # (T,) bool: the frame had a detection
    none_index: torch.Tensor  # (T,) bool mask of missing frames (pre-fill)
    sel_idx: torch.Tensor     # (T,) int64: the chosen slot of each frame


def select_person_sequence(boxes_cxcywh, keypoints, kpt_scores=None,
                           det_valid=None, track_ids=None) -> SelectedSequence:
    """Pick one athlete per frame for the whole clip."""
    boxes = torch.as_tensor(boxes_cxcywh)
    kpts = torch.as_tensor(keypoints, device=boxes.device)
    if kpts.shape[-1] == 3 and kpt_scores is None:
        kpt_scores = kpts[..., 2]
    kpts = kpts[..., :2]
    T, N = boxes.shape[:2]
    dev = boxes.device
    if kpt_scores is None:
        kpt_scores = torch.ones((T, N, kpts.shape[2]), dtype=boxes.dtype,
                                device=dev)
    kpt_scores = torch.as_tensor(kpt_scores, device=dev)
    det_valid = (torch.ones((T, N), dtype=torch.bool, device=dev)
                 if det_valid is None
                 else torch.as_tensor(det_valid, device=dev).to(torch.bool))
    track_ids = (torch.full((T, N), -1, dtype=torch.int32, device=dev)
                 if track_ids is None
                 else torch.as_tensor(track_ids, device=dev).to(torch.int32))

    centers = boxes[..., :2]
    areas = boxes[..., 2] * boxes[..., 3]
    prev_center = torch.zeros(2, dtype=boxes.dtype, device=dev)
    prev_ok = torch.zeros((), dtype=torch.bool, device=dev)
    prev_tid = torch.full((), -1, dtype=torch.int32, device=dev)
    sel, any_dets = [], []
    for t in range(T):
        v, c, tid = det_valid[t], centers[t], track_ids[t]
        any_det = v.any()
        same_id = v & (tid >= 0) & (tid == prev_tid) & (prev_tid >= 0)
        diff = c - prev_center
        d = torch.sqrt(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
        d = torch.where(v, d, torch.full_like(d, _BIG))
        a_masked = torch.where(v, areas[t], torch.full_like(areas[t], -_BIG))
        idx = torch.where(
            same_id.any(), torch.argmax(same_id.to(torch.int32)),
            torch.where(prev_ok & any_det, torch.argmin(d),
                        torch.argmax(a_masked)))
        prev_center = torch.where(any_det, c[idx], prev_center)
        prev_ok = prev_ok | any_det
        prev_tid = torch.where(any_det, tid[idx], prev_tid)
        sel.append(idx)
        any_dets.append(any_det)
    sel_idx = (torch.stack(sel) if T
               else torch.zeros(0, dtype=torch.long, device=dev))
    frame_valid = (torch.stack(any_dets) if T
                   else torch.zeros(0, dtype=torch.bool, device=dev))
    tsel = torch.arange(T, device=dev)
    return SelectedSequence(
        keypoints=kpts[tsel, sel_idx], scores=kpt_scores[tsel, sel_idx],
        boxes=boxes[tsel, sel_idx], valid=frame_valid,
        none_index=~frame_valid, sel_idx=sel_idx)


def fill_invalid_frames(x, valid):
    """Replace invalid frames with the **next** valid frame's value, falling
    back to the previous valid one at the tail (zeros when no frame is
    valid). ``x (T, ...)``, ``valid (T,)`` bool. Every output frame is a
    copy of an input frame, so the result is exact."""
    x = torch.as_tensor(x)
    valid = torch.as_tensor(valid, device=x.device).to(torch.bool)
    T = x.shape[0]
    t = torch.arange(T, device=x.device)
    # last valid index at or before t, first valid index at or after t
    prev = torch.cummax(torch.where(valid, t, torch.full_like(t, -1)), 0)[0]
    nxt = torch.cummin(torch.where(valid, t, torch.full_like(t, T)).flip(0),
                       0)[0].flip(0)
    src = torch.where(nxt < T, nxt, prev)
    out = x[src.clamp(min=0)]
    shape = (T,) + (1,) * (x.dim() - 1)
    return torch.where((src >= 0).reshape(shape), out, torch.zeros_like(out))
