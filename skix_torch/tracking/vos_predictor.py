"""SAM2-style interactive video-object-segmentation predictor, prompted by
masks.

Port of ``skix/tracking/vos_predictor.py`` (the reference's
``sam3_tracking_predictor.py``): ``add_new_mask`` (:342) pins an object's
mask on any frame as conditioning memory; ``propagate_in_video`` streams
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

Clicks and boxes (``add_new_points_or_box``) need skix's SAM prompt head,
which comes with a later slice: without a segmenter the method raises
skix's ``RuntimeError``, and passing one raises ``NotImplementedError``.
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

_SEGMENTER_SLICE = ("ROADMAP Queue 1 item 11b (the SAM prompt encoder and "
                    "decoder)")


class InteractiveVideoPredictor:
    """Interactive VOS session driver (see the module docstring)."""

    def __init__(self, tracker, segmenter=None, max_cond_frames: int = 2,
                 num_recent: int = 2, max_cond_slots: int = 16):
        if segmenter is not None:
            raise NotImplementedError(
                f"the interactive segmenter comes with {_SEGMENTER_SLICE}")
        if max_cond_frames < 2:
            # select_closest_cond_frames needs 2 or more: fail here, not
            # inside the propagation loop
            raise ValueError("max_cond_frames must be >= 2 "
                             f"(got {max_cond_frames})")
        self.tracker = tracker
        self.max_cond_frames = int(max_cond_frames)
        self.num_recent = int(num_recent)
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

    def add_new_points_or_box(self, state: dict, frame_idx: int,
                              obj_id: int, points=None, labels=None,
                              box=None, clear_old_points: bool = True,
                              rel_coordinates: bool = False):
        """Click and box prompts need the interactive segmenter."""
        raise RuntimeError(
            "point/box prompts need an InteractiveSegmenter; use "
            "add_new_mask or construct with segmenter=")

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
