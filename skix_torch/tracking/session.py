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
``smoke_prompts=True`` for the Sam3Detector: skix's smoke mode). Point and
box prompts (Sam3Detector only) fill fixed slots per frame, in normalized
coordinates, and condition that frame's detection through the detector's
geometry encoder; without a text prompt the session prompts ``"visual"``.

``handle_request`` and ``handle_stream_request`` are the reference's dict
request protocol (its ``bounding_boxes`` in normalized xywh).
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
from skix_torch.tracking.sam3_detector import geometry_slots
from skix_torch.utils.image import resize

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Session:
    frames: np.ndarray            # (T, H, W, 3) uint8
    prompts: Dict[str, np.ndarray]
    removed_ids: set
    # frame_idx → the frame's geometry slots (normalized coordinates)
    geometry: Dict[int, dict] = dataclasses.field(default_factory=dict)
    # text → (L,) bool pad mask (True = padding token) of a CLIP prompt;
    # hash prompts have none (all tokens valid)
    prompt_pads: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


class VideoPredictor:
    """start_session → add_prompt(text=...) → propagate_in_video (stream)."""

    def __init__(self, detector=None, tracker=None, masklet_cfg=None,
                 smoke_prompts: bool = False, clip=None, timer=None,
                 tracker_cfg: Optional[TrackerConfig] = None,
                 batch_size: int = 4, text_encoder=None, rng_seed: int = 0):
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
        ``tracker``/``outputs`` spans and the per-prompt ``clip`` span.
        ``rng_seed`` seeds the geometry encoder that the predictor keeps
        for a Sam3Detector built without one, made at the first point or
        box prompt; the detector is not changed."""
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
        self.rng_seed = int(rng_seed)
        self.geometry_encoder = None
        self.device = next(detector.parameters()).device
        self.sessions: Dict[int, _Session] = {}
        self._next_session = 0

    # ---------------- request API ----------------
    def handle_request(self, request: dict) -> Optional[dict]:
        """The reference's dict request protocol: dispatch on
        ``request["type"]``. ``start_session`` takes ``frames`` or a
        ``resource_path`` (a video or a directory of frames); ``add_prompt``
        takes the protocol's ``bounding_boxes`` in normalized 0-1 xywh,
        converted here to the pixel xyxy of :meth:`add_prompt`."""
        rt = request["type"]
        if rt == "start_session":
            if "frames" in request:
                frames = np.asarray(request["frames"])
            else:
                from skix_torch.io.video import read_video

                frames = read_video(request["resource_path"])
            return {"session_id": self.start_session(
                frames, session_id=request.get("session_id"))}
        if rt == "add_prompt":
            boxes = request.get("bounding_boxes")
            if boxes is not None:
                b = np.asarray(boxes, np.float32)
                H, W = self.sessions[request["session_id"]].frames.shape[1:3]
                b = b * np.asarray([W, H, W, H], np.float32)
                boxes = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], -1)
            fi = request.get("frame_index", 0)
            self.add_prompt(request["session_id"], text=request.get("text"),
                            frame_idx=fi, points=request.get("points"),
                            point_labels=request.get("point_labels"),
                            boxes_xyxy=boxes,
                            box_labels=request.get("bounding_box_labels"))
            return {"frame_index": fi}
        if rt == "remove_object":
            self.remove_object(request["session_id"], request["obj_id"])
            return None
        if rt == "reset_session":
            self.reset_session(request["session_id"])
            return None
        if rt == "close_session":
            self.close_session(request["session_id"])
            return None
        raise RuntimeError(f"invalid request type: {rt}")

    def handle_stream_request(self, request: dict) -> Iterator[dict]:
        """The protocol's streaming half; its direction defaults to
        "both", as the reference's does."""
        if request["type"] != "propagate_in_video":
            raise RuntimeError(f"invalid request type: {request['type']}")
        yield from self.propagate_in_video(
            request["session_id"], request.get("text"),
            start_frame_idx=request.get("start_frame_index"),
            max_frame_num_to_track=request.get("max_frame_num_to_track"),
            propagation_direction=request.get("propagation_direction",
                                              "both"))

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
        encoder's vector or the hash embedding. Points ``(P, 2)`` and
        ``boxes_xyxy`` ``(N, 4)`` in frame pixels (labels 1 = positive,
        the default, 0 = negative; Sam3Detector only) fill the free slots
        of ``frame_idx``: repeated calls accumulate, and prompts past
        ``max_points``/``max_boxes`` are dropped with a warning."""
        s = self.sessions[session_id]
        if points is not None or boxes_xyxy is not None:
            self._add_geometry(s, int(frame_idx), points, point_labels,
                               boxes_xyxy, box_labels)
        if text is None:
            return
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

    def _add_geometry(self, s: _Session, frame_idx: int, points,
                      point_labels, boxes_xyxy, box_labels) -> None:
        if not self.is_sam3:
            raise ValueError("geometric prompts need the Sam3Detector path")
        det = self.detector
        if self.geometry_encoder is None:
            self.geometry_encoder = (
                det.geometry_encoder if det.geometry_encoder is not None
                else det.make_geometry_encoder(
                    torch.Generator().manual_seed(self.rng_seed)))
        H, W = s.frames.shape[1:3]
        Np, Nb = det.max_points, det.max_boxes
        g = s.geometry.get(frame_idx)
        if g is None:
            g = geometry_slots(Np, Nb)

        def take(kind, arr, labels, cap):
            lab = (np.asarray(labels, np.int32).reshape(-1)
                   if labels is not None else np.ones(len(arr), np.int32))
            o = int(g[f"{kind}_valid"].sum())
            k = min(len(arr), cap - o)
            if k < len(arr):
                log.warning("frame %d %s slots full (%d/%d): dropping %d %s "
                            "prompt(s); reset_session to start over",
                            frame_idx, kind, o, cap, len(arr) - k, kind)
            g[f"{kind}_labels"][o:o + k] = lab[:k]
            g[f"{kind}_valid"][o:o + k] = True
            return o, k

        if points is not None:
            pts = np.asarray(points, np.float32).reshape(-1, 2)
            o, k = take("point", pts, point_labels, Np)
            g["points"][o:o + k] = pts[:k] / [W, H]
        if boxes_xyxy is not None:
            bx = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
            o, k = take("box", bx, box_labels, Nb)
            # normalized cxcywh, the geometry encoder's convention
            cx = (bx[:k, 0] + bx[:k, 2]) / 2 / W
            cy = (bx[:k, 1] + bx[:k, 3]) / 2 / H
            bw = (bx[:k, 2] - bx[:k, 0]) / W
            bh = (bx[:k, 3] - bx[:k, 1]) / H
            g["boxes"][o:o + k] = np.stack([cx, cy, bw, bh], -1)
        s.geometry[frame_idx] = g

    def remove_object(self, session_id: int, obj_id: int) -> None:
        self.sessions[session_id].removed_ids.add(int(obj_id))

    def reset_session(self, session_id: int) -> None:
        s = self.sessions[session_id]
        s.prompts.clear()
        s.prompt_pads.clear()
        s.removed_ids.clear()
        s.geometry.clear()

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
        geometry_by_frame = {
            local_t: {**{k: torch.as_tensor(v, device=mdl.device)[None]
                         for k, v in g.items()},
                      "geometry_encoder": self.geometry_encoder}
            for local_t, gt in enumerate(idx_map)
            if (g := s.geometry.get(int(gt))) is not None}
        stream = mdl.propagate(frames, torch.as_tensor(prompt),
                               geometry_by_frame=geometry_by_frame,
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
        walks ``s0 → 0``; "both" does both (the start frame twice). Without
        ``prompt_text`` the latest text prompt is the active one; geometry
        alone prompts ``"visual"``."""
        s = self.sessions[session_id]
        if propagation_direction not in ("both", "forward", "backward"):
            raise ValueError(
                f"invalid propagation direction: {propagation_direction}")
        if prompt_text is None:
            if not s.prompts and s.geometry:
                self.add_prompt(session_id, "visual")
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
    def _detect_batch(self, images, prompt, geometry=None, text_pad=None):
        """``images (B, size, size, 3)`` → (boxes xyxy in detector pixels,
        scores), each ``(B, Q, ...)``; ``geometry``: the batch's slots."""
        if not self.is_sam3:
            det = self.detector(images, prompt)
            return det.boxes_xyxy, det.scores
        if text_pad is not None:
            text_pad = text_pad[None].expand(images.shape[0], -1)
        det = self.detector(images, prompt, text_pad,
                            geometry_encoder=self.geometry_encoder,
                            **(geometry or {}))
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
        use_geo = self.is_sam3 and bool(s.geometry)
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
                geometry = None
                if use_geo:
                    # every frame of the batch has slots, all invalid on
                    # frames without a prompt
                    gb = geometry_slots(self.detector.max_points,
                                        self.detector.max_boxes, (B,))
                    for i in range(n):
                        g = s.geometry.get(int(idx_map[start + i]))
                        if g is not None:
                            for k in gb:
                                gb[k][i] = g[k]
                    geometry = {k: torch.as_tensor(v, device=dev)
                                for k, v in gb.items()}
                boxes, scores = self._detect_batch(
                    imgs, prompt.expand(B, *prompt.shape[1:]), geometry,
                    text_pad)
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

    # ---------------- stats ----------------
    def session_stats(self, session_id: int) -> dict:
        s = self.sessions[session_id]
        return {"frames": int(len(s.frames)), "prompts": sorted(s.prompts),
                "removed_ids": sorted(s.removed_ids),
                "geometry_frames": sorted(s.geometry)}
