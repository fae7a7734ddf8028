"""SAM2-style interactive video-object-segmentation predictor.

Port of ``skix/tracking/vos_predictor.py`` (the reference's
``sam3_tracking_predictor.py``): ``add_new_points_or_box`` (:179: a box
becomes two corner points with labels 2/3 ahead of the clicks; correction
clicks decode against the frame's existing mask) and ``add_new_mask``
(:342) pin an object's mask on any frame as conditioning memory;
``propagate_in_video`` streams
each object's masks forward or in reverse with the memory-conditioned
tracker; ``clear_all_points_in_frame`` (:906), ``clear_all_points_in_video``
(:978) and ``remove_object`` (:1181) complete the session. The memory bank
of each step has fixed slots (``max_cond_frames`` conditioning frames,
chosen by :func:`skix_torch.tracking.point_sampling.
select_closest_cond_frames`, then ``num_recent`` recent memories; invalid
slots masked), and the interactive state lives on the host, as in skix.
The tracker's weights decide the device.

Each step attends over its bank with the slot scan (``attend_decode`` with
``dense=False``, skix's default there), plain torch: no kernel launch.

Clicks and boxes need an :class:`skix_torch.tracking.sam_prompt_encoder.
InteractiveSegmenter` (``segmenter=``, its weights on the tracker's
device): each prompted frame is encoded once at the segmenter's size
(cached in the state's ``seg_feats``), and the selected mask logits,
resized to the tracker's grid, become the conditioning memory. Without a
segmenter the method raises skix's ``RuntimeError``.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import numpy as np
import torch

from skix_torch.tracking.memory_tracker import MemoryBank
from skix_torch.tracking.point_sampling import select_closest_cond_frames
from skix_torch.utils.image import resize

log = logging.getLogger(__name__)

_TOP_LEFT, _BOTTOM_RIGHT = 2, 3      # SAM box-corner point labels


class InteractiveVideoPredictor:
    """Interactive VOS session driver (see the module docstring)."""

    def __init__(self, tracker, segmenter=None, max_cond_frames: int = 2,
                 num_recent: int = 2, max_points: int = 8,
                 max_cond_slots: int = 16):
        if max_cond_frames < 2:
            # select_closest_cond_frames needs 2 or more: fail here, not
            # inside the propagation loop
            raise ValueError("max_cond_frames must be >= 2 "
                             f"(got {max_cond_frames})")
        self.tracker = tracker
        self.segmenter = segmenter
        self.max_cond_frames = int(max_cond_frames)
        self.num_recent = int(num_recent)
        self.max_points = int(max_points)
        self.max_cond_slots = int(max_cond_slots)
        self.device = next(tracker.parameters()).device

    # ------------------------------------------------------------ state

    def init_state(self, frames) -> dict:
        """``frames (T, H, W, 3)`` uint8, or float in [0, 1]."""
        f = np.asarray(frames)
        if f.dtype == np.uint8:
            f = f.astype(np.float32) / 255.0
        return {
            "frames": f,
            "num_frames": f.shape[0],
            "grid_hw": self.tracker.encoder.feature_hw(*f.shape[1:3]),
            "feats": {},            # frame_idx -> (1, gh, gw, C)
            "seg_feats": {},        # frame_idx -> segmenter embedding
            "objects": {},          # obj_id -> per-object dict
            "last_cond_selected": None,   # the last bank's cond frames
        }

    def _obj(self, state: dict, obj_id: int) -> dict:
        if obj_id not in state["objects"]:
            state["objects"][obj_id] = {
                "cond": {},          # frame_idx -> (gh, gw, C) memory
                "cond_logits": {},   # frame_idx -> (gh, gw) grid logits
                "points": {},        # frame_idx -> (coords, labels)
                "masks": {},         # frame_idx -> (gh, gw) grid logits
            }
        return state["objects"][obj_id]

    def _feats(self, state: dict, t: int):
        if t not in state["feats"]:
            img = torch.as_tensor(state["frames"][t], dtype=torch.float32,
                                  device=self.device)[None]
            state["feats"][t] = self.tracker.encode_frame(img)
        return state["feats"][t]

    def _encode_memory(self, state: dict, t: int, grid_logits):
        return self.tracker.encode_memory(self._feats(state, t),
                                          grid_logits[None])[0]

    # ---------------------------------------------------------- prompts

    @torch.no_grad()
    def add_new_mask(self, state: dict, frame_idx: int, obj_id: int, mask):
        """Condition ``obj_id`` on a binary ``mask (H, W)`` at
        ``frame_idx`` (nearest-resized to the grid, logits ±10). Returns
        the conditioning grid logits ``(gh, gw)``."""
        obj = self._obj(state, obj_id)
        m = torch.as_tensor(np.asarray(mask), dtype=torch.float32,
                            device=self.device)
        grid = resize(m, state["grid_hw"], "nearest") * 20.0 - 10.0
        obj["cond"][frame_idx] = self._encode_memory(state, frame_idx, grid)
        obj["cond_logits"][frame_idx] = grid
        obj["masks"][frame_idx] = grid
        obj["points"].pop(frame_idx, None)
        return grid

    @torch.no_grad()
    def add_new_points_or_box(self, state: dict, frame_idx: int,
                              obj_id: int, points=None, labels=None,
                              box=None, clear_old_points: bool = True,
                              rel_coordinates: bool = False):
        """Clicks ``points (P, 2)`` with ``labels (P,)`` (1 = positive, 0 =
        negative) and/or a ``box`` (xyxy), in frame pixels (or relative
        with ``rel_coordinates``): the segmenter decodes this frame's mask
        (against the frame's existing mask, when it has one), which is
        pinned as conditioning memory. A box goes ahead of the clicks as
        two corner points, so it needs ``clear_old_points``; past
        ``max_points`` the first prompts stay (the corners among them).
        Returns the grid logits ``(gh, gw)``."""
        if self.segmenter is None:
            raise RuntimeError(
                "point/box prompts need an InteractiveSegmenter; use "
                "add_new_mask or construct with segmenter=")
        if (points is None) != (labels is None):
            raise ValueError("points and labels must be provided together")
        if points is None and box is None:
            raise ValueError(
                "at least one of points or box must be provided as input")
        obj = self._obj(state, obj_id)
        H, W = state["frames"].shape[1:3]
        s = self.segmenter.img_size
        pts = (np.zeros((0, 2), np.float32) if points is None
               else np.asarray(points, np.float32).reshape(-1, 2))
        lab = (np.zeros((0,), np.int32) if labels is None
               else np.asarray(labels, np.int32).reshape(-1))
        if rel_coordinates:
            pts = pts * np.asarray([W, H], np.float32)
            if box is not None:
                box = np.asarray(box, np.float32) * np.asarray(
                    [W, H, W, H], np.float32)
        if box is not None:
            if not clear_old_points:
                raise ValueError(
                    "cannot add box without clearing old points, since "
                    "box prompt must be provided before any point prompt "
                    "(please use clear_old_points=True instead)")
            pts = np.concatenate(
                [np.asarray(box, np.float32).reshape(2, 2), pts], axis=0)
            lab = np.concatenate(
                [np.asarray([_TOP_LEFT, _BOTTOM_RIGHT], np.int32), lab])
        if not clear_old_points and frame_idx in obj["points"]:
            old_p, old_l = obj["points"][frame_idx]
            pts = np.concatenate([old_p, pts], axis=0)
            lab = np.concatenate([old_l, lab], axis=0)
        obj["points"][frame_idx] = (pts, lab)

        # fixed prompt slots (−1 pads), the head kept: a lone trailing
        # corner would give the SAM head half a box
        P = self.max_points
        pad_p = np.zeros((1, P, 2), np.float32)
        pad_l = np.full((1, P), -1, np.int32)
        n = min(len(lab), P)
        if n < len(lab):
            log.warning("prompt slots full (%d clicks > %d): keeping the "
                        "FIRST %d — box corner points (labels 2/3) sit at "
                        "the front and must survive truncation", len(lab),
                        P, n)
        pad_p[0, :n] = pts[:n] * np.asarray([s / W, s / H], np.float32)
        pad_l[0, :n] = lab[:n]

        if frame_idx not in state["seg_feats"]:
            img = torch.as_tensor(state["frames"][frame_idx],
                                  dtype=torch.float32, device=self.device)
            state["seg_feats"][frame_idx] = self.segmenter.encode_image(
                resize(img, (s, s, 3))[None])
        feats = state["seg_feats"][frame_idx]
        # correction clicks decode against the frame's existing mask
        mask_in = None
        prev = obj["masks"].get(frame_idx, obj["cond_logits"].get(frame_idx))
        if prev is not None:
            fh, fw = feats.shape[1], feats.shape[2]
            mask_in = resize(prev, (4 * fh, 4 * fw))[None, :, :, None]
        out = self.segmenter.predict_from_embedding(
            feats, torch.as_tensor(pad_p, device=self.device),
            torch.as_tensor(pad_l, device=self.device), None, mask_in)
        grid = resize(out.mask_logits[0], state["grid_hw"])
        obj["cond"][frame_idx] = self._encode_memory(state, frame_idx, grid)
        obj["cond_logits"][frame_idx] = grid
        obj["masks"][frame_idx] = grid
        return grid

    # ----------------------------------------------------- maintenance

    def clear_all_points_in_frame(self, state: dict, frame_idx: int,
                                  obj_id: int) -> None:
        """Drop the prompts and the conditioning they produced on one
        frame."""
        obj = self._obj(state, obj_id)
        for key in ("points", "cond", "cond_logits", "masks"):
            obj[key].pop(frame_idx, None)

    def clear_all_points_in_video(self, state: dict) -> None:
        """Every object keeps its identity but loses its click-derived
        conditioning."""
        for obj_id in list(state["objects"]):
            for t in list(self._obj(state, obj_id)["points"]):
                self.clear_all_points_in_frame(state, t, obj_id)

    def remove_object(self, state: dict, obj_id: int,
                      strict: bool = False) -> None:
        if obj_id not in state["objects"]:
            if strict:
                raise KeyError(f"unknown obj_id {obj_id}")
            return
        del state["objects"][obj_id]

    # ----------------------------------------------------- propagation

    def _bank_for(self, state: dict, obj: dict, frame_idx: int,
                  recents: list) -> MemoryBank:
        """One object's bank for ``frame_idx``: the chosen conditioning
        memories, then its recent ones, in ``max_cond_frames + num_recent``
        fixed slots."""
        gh, gw = state["grid_hw"]
        M = self.max_cond_frames + self.num_recent
        mem = torch.zeros((1, M, gh, gw, self.tracker.features),
                          device=self.device)
        valid = torch.zeros((1, M), dtype=torch.bool, device=self.device)

        cond_ts = sorted(obj["cond"])
        S = self.max_cond_slots
        if len(cond_ts) > S:
            log.warning("%d conditioning frames > %d slots — keeping the "
                        "%d nearest to frame %d", len(cond_ts), S, S,
                        frame_idx)
            cond_ts = sorted(sorted(cond_ts,
                                    key=lambda t: abs(t - frame_idx))[:S])
        t_slots = np.zeros(S, np.int64)
        v_slots = np.zeros(S, bool)
        t_slots[:len(cond_ts)] = cond_ts
        v_slots[:len(cond_ts)] = True
        sel, _ = select_closest_cond_frames(
            frame_idx, t_slots, v_slots, self.max_cond_frames
            if len(cond_ts) > self.max_cond_frames else -1)
        chosen = [int(t) for t, s in zip(t_slots, sel.tolist()) if s]
        state["last_cond_selected"] = chosen
        feats = ([obj["cond"][t] for t in chosen[:self.max_cond_frames]]
                 + recents[-self.num_recent:])
        for i, feat in enumerate(feats):
            mem[0, i] = feat
            valid[0, i] = True
        return MemoryBank(mem=mem, valid=valid,
                          ring_pos=torch.ones(1, dtype=torch.int64,
                                              device=self.device))

    def propagate_in_video(self, state: dict,
                           start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           reverse: bool = False) -> Iterator[dict]:
        """Stream each object's masks: yields ``{"frame_index",
        "obj_ids", "masks" (N, H, W) bool, "logits" (N, gh, gw)}`` from
        ``start_frame_idx`` (default: the earliest conditioning frame, the
        latest when ``reverse``) for at most ``max_frame_num_to_track + 1``
        frames."""
        objs = {k: v for k, v in state["objects"].items() if v["cond"]}
        if not objs:
            raise RuntimeError("no prompted objects to propagate")
        T = state["num_frames"]
        cond_all = [t for o in objs.values() for t in o["cond"]]
        if start_frame_idx is None:
            start_frame_idx = max(cond_all) if reverse else min(cond_all)
        step = -1 if reverse else 1
        frame_ids = list(range(start_frame_idx, -1 if reverse else T, step))
        if max_frame_num_to_track is not None:
            frame_ids = frame_ids[:max_frame_num_to_track + 1]

        H, W = state["frames"].shape[1:3]
        recents: dict = {k: [] for k in objs}
        for t in frame_ids:
            with torch.no_grad():
                feats = self._feats(state, t)
                obj_ids, logits_list, masks_list = [], [], []
                for obj_id, obj in objs.items():
                    if t in obj["cond"]:
                        # the frame's memory is already its conditioning
                        # memory: not encoded again, not a recent one
                        lg = obj["cond_logits"][t]
                    else:
                        bank = self._bank_for(state, obj, t, recents[obj_id])
                        lg = self.tracker.attend_decode(feats, bank)[0][0]
                        recents[obj_id].append(
                            self._encode_memory(state, t, lg))
                        recents[obj_id] = recents[obj_id][-self.num_recent:]
                    obj["masks"][t] = lg
                    obj_ids.append(obj_id)
                    logits_list.append(lg)
                    masks_list.append(resize(lg, (H, W), "bilinear") > 0)
                out = {"frame_index": t, "obj_ids": obj_ids,
                       "logits": torch.stack(logits_list).cpu().numpy(),
                       "masks": torch.stack(masks_list).cpu().numpy()}
            yield out
