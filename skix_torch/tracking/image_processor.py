"""Image-level promptable detection: the ``Sam3Processor`` request API.

Port of ``skix/tracking/image_processor.py`` (the reference's
``sam3_image_processor.py``): ``set_image`` → ``set_text_prompt`` /
``add_geometric_prompt`` (boxes, positive or negative, added one at a
time) / ``add_point_prompt`` / ``reset_all_prompts`` /
``set_confidence_threshold``; every change of the prompts runs the detector
once on the cached image with fixed-capacity prompt slots and returns the
boxes, scores and masks above the threshold. A geometric prompt without a
text prompt runs with the text prompt ``"visual"``, as the reference does.

Text prompts go through the CLIP tower when one is given, else the
deterministic hash embedding (smoke mode). For a detector built without
the geometry encoder the processor keeps one of its own, drawn from a
generator seeded ``rng_seed`` (:meth:`~skix_torch.tracking.sam3_detector.
Sam3Detector.make_geometry_encoder`); the detector is not changed. skix
draws the missing branch with ``jax.random``, whose numbers the port cannot
reproduce, so only trained or converted geometry weights give skix's
results.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from skix_torch.tracking.sam3_detector import geometry_slots
from skix_torch.utils.image import resize

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _ImageState:
    image: torch.Tensor           # (1, S, S, 3) resized, [0, 1]
    original_hw: tuple
    text_memory: Optional[torch.Tensor] = None    # (1, L, d_model)
    text_pad: Optional[torch.Tensor] = None       # (1, L) bool True = pad
    boxes: Optional[np.ndarray] = None            # (Nb, 4) normalized cxcywh
    box_labels: Optional[np.ndarray] = None       # (Nb,)
    points: Optional[np.ndarray] = None           # (Np, 2) normalized xy
    point_labels: Optional[np.ndarray] = None     # (Np,)
    results: Optional[Dict] = None


class Sam3Processor:
    """set_image → set_text_prompt / add_geometric_prompt → results."""

    def __init__(self, detector, clip=None, confidence_threshold: float = 0.5,
                 rng_seed: int = 0):
        """``detector``: a :class:`~skix_torch.tracking.sam3_detector.
        Sam3Detector` with its weights; ``clip``: optional ``(ClipTokenizer,
        VETextEncoder)`` pair, the encoder on the detector's device. The
        point and box prompts go through the detector's geometry encoder,
        or one seeded ``rng_seed`` when it has none."""
        self.detector = detector
        self.geometry_encoder = (
            detector.geometry_encoder if detector.geometry_encoder is not None
            else detector.make_geometry_encoder(
                torch.Generator().manual_seed(rng_seed)))
        self.clip = clip
        self.confidence_threshold = float(confidence_threshold)
        self.device = next(detector.parameters()).device

    # ---------------- request API ----------------
    @torch.no_grad()
    def set_image(self, image: np.ndarray, state: Optional[dict] = None
                  ) -> _ImageState:
        """``image (H, W, 3)`` uint8 (0..255) or float (0..1) → state; the
        scaling follows the dtype."""
        image = np.asarray(image)
        H, W = image.shape[:2]
        img = torch.as_tensor(image, device=self.device).to(torch.float32)
        if np.issubdtype(image.dtype, np.integer):
            img = img / 255.0
        size = self.detector.img_size
        return _ImageState(image=resize(img, (size, size, 3))[None],
                           original_hw=(H, W))

    @torch.no_grad()
    def set_text_prompt(self, prompt: str, state: _ImageState) -> Dict:
        if self.clip is not None:
            tokenizer, encoder = self.clip
            tokens = torch.as_tensor(tokenizer([prompt]), device=self.device)
            valid, resized, _ = encoder(tokens)
            state.text_memory = resized
            # the tower's mask is True = valid, the detector's True = pad
            state.text_pad = ~valid
        else:
            from skix_torch.tracking.detector import embed_text_prompt

            vec = embed_text_prompt(prompt, self.detector.d_model)
            state.text_memory = torch.as_tensor(
                np.tile(vec[None, None], (1, 4, 1)), device=self.device)
            state.text_pad = torch.zeros((1, 4), dtype=torch.bool,
                                         device=self.device)
        return self._run(state)

    def add_geometric_prompt(self, box: List[float], label: bool,
                             state: _ImageState) -> Dict:
        """``box`` normalized [cx, cy, w, h]; ``label`` True = positive.
        Past ``max_boxes`` the most recent boxes stay."""
        b = np.asarray(box, np.float32)[None]
        lb = np.asarray([1 if label else 0], np.int32)
        state.boxes = b if state.boxes is None else np.concatenate(
            [state.boxes, b])
        state.box_labels = lb if state.box_labels is None else np.concatenate(
            [state.box_labels, lb])
        n = self.detector.max_boxes
        if len(state.boxes) > n:
            log.warning("more than %d box prompts; keeping the most recent", n)
            state.boxes = state.boxes[-n:]
            state.box_labels = state.box_labels[-n:]
        return self._run(state)

    def add_point_prompt(self, point: List[float], label: bool,
                         state: _ImageState) -> Dict:
        """``point`` normalized [x, y]; ``label`` True = positive. Past
        ``max_points`` the most recent points stay."""
        p = np.asarray(point, np.float32)[None]
        lb = np.asarray([1 if label else 0], np.int32)
        state.points = p if state.points is None else np.concatenate(
            [state.points, p])
        state.point_labels = (lb if state.point_labels is None
                              else np.concatenate([state.point_labels, lb]))
        n = self.detector.max_points
        if len(state.points) > n:
            state.points = state.points[-n:]
            state.point_labels = state.point_labels[-n:]
        return self._run(state)

    def reset_all_prompts(self, state: _ImageState) -> _ImageState:
        state.text_memory = state.text_pad = None
        state.boxes = state.box_labels = None
        state.points = state.point_labels = None
        state.results = None
        return state

    def set_confidence_threshold(self, threshold: float,
                                 state: Optional[_ImageState] = None):
        self.confidence_threshold = float(threshold)
        if state is not None and state.results is not None:
            return self._run(state)
        return None

    # ---------------- grounding ----------------
    @torch.no_grad()
    def _run(self, state: _ImageState) -> Dict:
        if state.text_memory is None:
            # geometric-only prompting: the reference's "visual" text prompt
            if state.boxes is None and state.points is None:
                return {}
            return self.set_text_prompt("visual", state)
        g = geometry_slots(self.detector.max_points, self.detector.max_boxes,
                           (1,))
        for (v, lab, ok), values, labels in (
                (("points", "point_labels", "point_valid"), state.points,
                 state.point_labels),
                (("boxes", "box_labels", "box_valid"), state.boxes,
                 state.box_labels)):
            if values is not None:
                g[v][0, :len(values)] = values
                g[lab][0, :len(values)] = labels
                g[ok][0, :len(values)] = True
        det = self.detector(state.image, state.text_memory, state.text_pad,
                            geometry_encoder=self.geometry_encoder,
                            **{k: torch.as_tensor(v, device=self.device)
                               for k, v in g.items()})
        # per-query probabilities gated by the presence head
        probs = torch.sigmoid(det.scores[0]) * torch.sigmoid(det.presence[0])
        boxes = det.boxes_cxcywh[0].cpu().numpy()
        scores = probs.cpu().numpy()
        keep = scores >= self.confidence_threshold
        # only the kept queries' mask logits cross to the host
        masks = det.mask_logits[0][torch.as_tensor(keep, device=self.device)
                                   ].cpu().numpy()
        H, W = state.original_hw
        xyxy = np.stack([(boxes[:, 0] - boxes[:, 2] / 2) * W,
                         (boxes[:, 1] - boxes[:, 3] / 2) * H,
                         (boxes[:, 0] + boxes[:, 2] / 2) * W,
                         (boxes[:, 1] + boxes[:, 3] / 2) * H], -1)
        state.results = {"boxes_xyxy": xyxy[keep], "scores": scores[keep],
                         "masks_lowres": masks,
                         "presence": float(det.presence[0]),
                         "all_boxes_xyxy": xyxy, "all_scores": scores}
        return state.results
