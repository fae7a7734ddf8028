"""Video-tracking session API.

Port of ``skix/tracking/session.py``: ``start_session`` →
``add_prompt(text=...)`` → ``propagate_in_video`` (streaming) →
``reset_session`` / ``close_session``. Two propagation paths, as in skix:

- masklet propagation (a ``Sam3Detector`` with a ``MaskMemoryTracker``):
  per-object masks through the memory tracker;
- box-level tracking (the compact :class:`~skix_torch.tracking.detector.
  DetrDetector`, or a ``Sam3Detector`` without a tracker): frames resized
  to the detector's size in batches of ``batch_size`` (the last padded),
  detections scaled back to the frame and the slot lifecycle
  (:mod:`skix_torch.tracking.lifecycle`) stepped frame by frame, one host
  copy a batch.

Text prompts go through the CLIP tower (``clip=(tokenizer, encoder)``: the
reference path), the byte-level ``text_encoder`` (compact path) or,
without either, the deterministic hash embedding (compact, or
``smoke_prompts=True`` for the Sam3Detector: skix's smoke mode).
Geometric prompts come with a later slice and raise
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
from skix_torch.tracking.lifecycle import (TrackerConfig, init_tracker_state,
                                           tracker_step)
from skix_torch.utils.image import resize

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
                 smoke_prompts: bool = False, clip=None, timer=None,
                 tracker_cfg: Optional[TrackerConfig] = None,
                 batch_size: int = 4, text_encoder=None):
        """``detector``: a compact :class:`skix_torch.tracking.detector.
        DetrDetector` or a :class:`skix_torch.tracking.sam3_detector.
        Sam3Detector`, with its weights; ``tracker``: a :class:`skix_torch.
        tracking.memory_tracker.MaskMemoryTracker` on the same device
        (masklet propagation, Sam3Detector only), or None for box-level
        tracking under ``tracker_cfg`` in batches of ``batch_size``.
        ``clip``: optional ``(ClipTokenizer, VETextEncoder)`` pair, the
        encoder with its weights on the detector's device: text prompts
        then go through the CLIP tower (skix's ``(tokenizer, encoder,
        variables)`` triple). ``text_encoder``: optional :class:`skix_torch.
        tracking.text_encoder.TextEncoder` for the compact path's prompts.
        ``timer``: optional ``StageTimer`` for the per-frame ``detector``/
        ``tracker``/``outputs`` spans and the per-prompt ``clip`` span."""
        from skix_torch.tracking.detector import DetrDetector
        from skix_torch.tracking.sam3_detector import Sam3Detector

        self.is_sam3 = isinstance(detector, Sam3Detector)
        if not (self.is_sam3 or isinstance(detector, DetrDetector)):
            raise TypeError("detector: a DetrDetector or a Sam3Detector")
        if tracker is not None and not self.is_sam3:
            raise ValueError("masklet propagation (tracker=...) needs the "
                             "Sam3Detector path (mask-producing detector)")
        self.clip = clip
        self.text_encoder = text_encoder
        self.detector = detector
        self.tracker = tracker
        self.masklet_cfg = masklet_cfg
        self.smoke_prompts = bool(smoke_prompts)
        self.timer = timer
        self.cfg = tracker_cfg or TrackerConfig()
        self.batch_size = int(batch_size)
        self.device = next(detector.parameters()).device
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
        mask; on the Sam3Detector without one (smoke mode) the hash
        embedding tiled to 4 tokens; on the compact path the text
        encoder's vector or the hash embedding."""
        if points is not None or boxes_xyxy is not None:
            raise NotImplementedError(
                "geometric prompts come with ROADMAP Queue 1 item 11 (the "
                "geometry prompts)")
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
        if self.is_sam3:
            if not self.smoke_prompts:
                raise ValueError(
                    "Sam3Detector text prompting needs a CLIP tower "
                    "(clip=(tokenizer, encoder)); pass smoke_prompts=True to "
                    "opt into the deterministic hash embeddings")
            vec = embed_text_prompt(text, self.detector.d_model)
            s.prompts[text] = np.tile(vec[None], (4, 1))
        elif self.text_encoder is not None:
            from skix_torch.tracking.text_encoder import encode_texts

            s.prompts[text] = encode_texts(self.text_encoder,
                                           [text])[0].cpu().numpy()
        else:
            s.prompts[text] = embed_text_prompt(text,
                                                self.detector.prompt_dim)

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
            if not idx_map:
                continue
            pad = s.prompt_pads.get(prompt_text)
            if self.tracker is not None:
                yield from self._propagate_masklets(
                    s, s.prompts[prompt_text], idx_map, pad)
            else:
                yield from self._propagate_boxes(s, prompt_text, idx_map, pad)

    @torch.no_grad()
    def _detect_batch(self, images, prompt, text_pad=None):
        """``images (B, size, size, 3)`` → (boxes xyxy in detector pixels,
        scores), each ``(B, Q, ...)``."""
        if not self.is_sam3:
            det = self.detector(images, prompt)
            return det.boxes_xyxy, det.scores
        if text_pad is not None:
            text_pad = text_pad[None].expand(images.shape[0], -1)
        det = self.detector(images, prompt, text_pad)
        cx, cy, w, h = det.boxes_cxcywh.unbind(-1)
        size = self.detector.img_size
        return torch.stack([(cx - w / 2) * size, (cy - h / 2) * size,
                            (cx + w / 2) * size, (cy + h / 2) * size],
                           dim=-1), det.scores

    def _span(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.span(name, sync=self.device.type == "cuda")

    def _propagate_boxes(self, s: _Session, prompt_text: str, idx_map,
                         text_pad=None) -> Iterator[dict]:
        """Box-level tracking over one ordered frame segment: a batch of
        frames through the detector, boxes scaled to the frame, the
        lifecycle stepped per frame, one host copy a batch."""
        dev = self.device
        prompt = torch.as_tensor(s.prompts[prompt_text], device=dev)[None]
        size = self.detector.img_size
        H, W = s.frames.shape[1:3]
        frames = s.frames[np.asarray(idx_map)]
        T, B = frames.shape[0], self.batch_size
        if text_pad is not None:
            text_pad = torch.as_tensor(text_pad, device=dev)
        state = init_tracker_state(self.cfg, dev)
        scale = torch.tensor([W / size, H / size] * 2, dtype=torch.float32,
                             device=dev)
        keys = ("active", "confirmed", "bbox", "score", "obj_id",
                "keep_alive")
        for start in range(0, T, B):
            chunk = torch.as_tensor(np.ascontiguousarray(
                frames[start:start + B]), device=dev)
            n = chunk.shape[0]
            with self._span("detector"):
                imgs = resize(chunk.to(torch.float32) / 255.0,
                              (n, size, size, 3), "bilinear")
                if n < B:
                    imgs = torch.nn.functional.pad(
                        imgs, (0, 0, 0, 0, 0, 0, 0, B - n))
                boxes, scores = self._detect_batch(
                    imgs, prompt.expand(B, *prompt.shape[1:]), text_pad)
                boxes = boxes[:n] * scale
                scores = scores[:n]
            with self._span("tracker"):
                outs = []
                valid = torch.ones(boxes.shape[1], dtype=torch.bool,
                                   device=dev)
                for i in range(n):
                    state, out = tracker_step(state, boxes[i], scores[i],
                                              valid, self.cfg)
                    outs.append(out)
                host = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                        for k in keys}
            for i in range(n):
                out_np = {k: host[k][i] for k in keys}
                if s.removed_ids:
                    drop = np.isin(out_np["obj_id"], list(s.removed_ids))
                    out_np["active"] = out_np["active"] & ~drop
                yield {"frame_index": int(idx_map[start + i]),
                       "outputs": out_np}
