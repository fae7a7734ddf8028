"""Video-tracking session API.

Port of ``skix/tracking/session.py`` on its ``Sam3Detector`` +
``MaskMemoryTracker`` branch (masklet propagation): ``start_session`` →
``add_prompt(text=...)`` → ``propagate_in_video`` (streaming) →
``reset_session`` / ``close_session``. Text prompts go through the CLIP
tower (``clip=(tokenizer, encoder)``: the reference path) or, without one,
the deterministic hash embedding (``smoke_prompts=True``, skix's smoke
mode). The compact ``DetrDetector``, box-level tracking without a memory
tracker and geometric prompts come with later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from skix_torch.tracking.detector import embed_text_prompt

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Session:
    frames: np.ndarray            # (T, H, W, 3) uint8
    prompts: Dict[str, np.ndarray]
    removed_ids: set
    # text → (L,) bool pad mask (True = padding token) of a CLIP prompt;
    # hash prompts have none (all tokens valid)
    prompt_pads: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


class VideoPredictor:
    """start_session → add_prompt(text=...) → propagate_in_video (stream)."""

    def __init__(self, detector=None, tracker=None, masklet_cfg=None,
                 smoke_prompts: bool = False, clip=None, timer=None):
        """``detector``: a :class:`skix_torch.tracking.sam3_detector.
        Sam3Detector` with its weights; ``tracker``: a :class:`skix_torch.
        tracking.memory_tracker.MaskMemoryTracker` on the same device
        (masklet propagation). ``clip``: optional ``(ClipTokenizer,
        VETextEncoder)`` pair, the encoder with its weights on the
        detector's device: text prompts then go through the CLIP tower
        (skix's ``(tokenizer, encoder, variables)`` triple). ``timer``:
        optional ``StageTimer`` for the per-frame ``detector``/``tracker``/
        ``outputs`` spans and the per-prompt ``clip`` span."""
        from skix_torch.tracking.sam3_detector import Sam3Detector

        if not isinstance(detector, Sam3Detector):
            raise NotImplementedError(
                "the compact DetrDetector comes with its own slice of the "
                "port; pass a Sam3Detector")
        if tracker is None:
            raise NotImplementedError(
                "box-level tracking without a memory tracker is not ported; "
                "pass tracker=MaskMemoryTracker(...)")
        self.clip = clip
        self.detector = detector
        self.tracker = tracker
        self.masklet_cfg = masklet_cfg
        self.smoke_prompts = bool(smoke_prompts)
        self.timer = timer
        self.sessions: Dict[int, _Session] = {}
        self._next_session = 0

    def start_session(self, frames: np.ndarray, session_id=None):
        if session_id is None:
            session_id = self._next_session
            self._next_session += 1
        self.sessions[session_id] = _Session(frames=np.asarray(frames),
                                             prompts={}, removed_ids=set())
        return session_id

    def add_prompt(self, session_id: int, text: Optional[str] = None,
                   frame_idx: int = 0, points=None, point_labels=None,
                   boxes_xyxy=None, box_labels=None) -> None:
        """A text prompt: the CLIP tower's resized token memory and pad
        mask, or (smoke mode) the hash embedding tiled to 4 tokens."""
        if points is not None or boxes_xyxy is not None:
            raise NotImplementedError(
                "geometric prompts come with the geometry-prompt slice")
        if text is None:
            return
        s = self.sessions[session_id]
        if self.clip is not None:
            tokenizer, encoder = self.clip
            dev = next(encoder.parameters()).device
            tokens = torch.as_tensor(tokenizer([text]), device=dev)
            span = (self.timer.span("clip", sync=dev.type == "cuda")
                    if self.timer is not None else contextlib.nullcontext())
            with torch.no_grad(), span:
                valid, resized, _ = encoder(tokens)
                s.prompts[text] = resized[0].cpu().numpy()   # (L, d_model)
                # the encoder's mask is True = valid, the detector's pad
                # mask True = pad: invert, or the fusion encoder attends to
                # the ~29 pad tokens of a 32-token prompt
                s.prompt_pads[text] = ~valid[0].cpu().numpy()
            return
        if not self.smoke_prompts:
            raise ValueError(
                "Sam3Detector text prompting needs a CLIP tower "
                "(clip=(tokenizer, encoder)); pass smoke_prompts=True to opt "
                "into the deterministic hash embeddings")
        vec = embed_text_prompt(text, self.detector.d_model)
        s.prompts[text] = np.tile(vec[None], (4, 1))

    def remove_object(self, session_id: int, obj_id: int) -> None:
        self.sessions[session_id].removed_ids.add(int(obj_id))

    def reset_session(self, session_id: int) -> None:
        s = self.sessions[session_id]
        s.prompts.clear()
        s.prompt_pads.clear()
        s.removed_ids.clear()

    def close_session(self, session_id: int) -> None:
        self.sessions.pop(session_id, None)

    def _propagate_masklets(self, s: _Session, prompt, idx_map,
                            text_pad=None) -> Iterator[dict]:
        """Masklet propagation over one ordered frame segment (forward, or
        a descending backward pass with the lifecycle's comparisons
        flipped); renames ``boxes`` → ``bbox`` and applies
        ``remove_object``."""
        from skix_torch.tracking.masklet import MaskletConfig, MaskletVideoModel

        cfg = self.masklet_cfg or MaskletConfig()
        reverse = len(idx_map) > 1 and idx_map[1] < idx_map[0]
        if cfg.reverse != reverse:
            cfg = dataclasses.replace(cfg, reverse=reverse)
        mdl = MaskletVideoModel(self.detector, self.tracker, cfg,
                                timer=self.timer)
        frames = np.ascontiguousarray(s.frames[np.asarray(idx_map)])
        if text_pad is not None:
            text_pad = torch.as_tensor(text_pad, device=mdl.device)
        stream = mdl.propagate(frames, torch.as_tensor(prompt),
                               include_lowres_logits=False,
                               start_frame=int(idx_map[0]),
                               text_pad=text_pad)
        for item in stream:
            out = item["outputs"]
            out_np = {"mask": out["mask"], "bbox": out["boxes"],
                      "score": out["score"],
                      "tracker_score": out["tracker_score"],
                      "active": out["active"], "confirmed": out["confirmed"],
                      "obj_id": out["obj_id"]}
            if s.removed_ids:
                drop = np.isin(out_np["obj_id"], list(s.removed_ids))
                out_np["active"] = out_np["active"] & ~drop
            yield {"frame_index": int(idx_map[item["frame_index"]]),
                   "outputs": out_np}

    def propagate_in_video(self, session_id: int,
                           prompt_text: Optional[str] = None,
                           start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           propagation_direction: str = "forward"
                           ) -> Iterator[dict]:
        """Yield per-frame ``{frame_index, outputs}`` with per-object
        ``mask`` arrays. Forward yields ``[s0, min(T, s0+max))``, backward
        walks ``s0 → 0``; "both" does both (the start frame twice)."""
        s = self.sessions[session_id]
        if propagation_direction not in ("both", "forward", "backward"):
            raise ValueError(
                f"invalid propagation direction: {propagation_direction}")
        if prompt_text is None:
            if not s.prompts:
                raise ValueError("no prompt added to session")
            prompt_text = next(reversed(s.prompts))
        T = s.frames.shape[0]
        s0 = 0 if start_frame_idx is None else int(start_frame_idx)
        maxn = T if max_frame_num_to_track is None \
            else int(max_frame_num_to_track)
        segments = []
        if propagation_direction in ("both", "forward"):
            segments.append(list(range(s0, min(T, s0 + maxn))))
        if propagation_direction in ("both", "backward"):
            segments.append(list(range(s0, max(-1, s0 - maxn), -1)))
        for idx_map in segments:
            if idx_map:
                yield from self._propagate_masklets(
                    s, s.prompts[prompt_text], idx_map,
                    s.prompt_pads.get(prompt_text))
