"""LLM + segmenter clients for the SAM3 agent.

Reference counterparts: ``sam3/agent/client_llm.py:34`` (HTTP request to
a Qwen-VL server) and ``sam3/agent/client_sam3.py:17 sam3_inference`` /
``:50 call_sam_service`` (run the image processor, normalize boxes to
xywh, RLE-encode masks, drop overlapping + degenerate masks, sort by
score).

Port of ``skix/agent/client.py``: the segmenter wraps the port's
``skix_torch.tracking.image_processor.Sam3Processor`` (one detector
forward on the processor's device per prompt mutation; only the kept
queries' low-res mask logits cross to the host, where they are upsampled
with cv2 and thresholded, as in skix) and results stay in memory as numpy
— the reference's JSON-file round trip is optional (``save_outputs``).
The LLM side is a plain callable protocol so tests and offline runs
inject a :class:`ScriptedLLM`; zero-egress environments cannot host the
reference's HTTP client, so the seam is the callable, not a URL.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from skix_torch.agent.som import remove_overlapping_masks

# messages (OpenAI-ish dicts, images as numpy arrays) -> generated text
LLMClient = Callable[[List[dict]], Optional[str]]


class ScriptedLLM:
    """Deterministic LLM stand-in: returns canned responses in order.

    Each call also records the messages it saw (``self.seen``) so tests
    can assert pruning invariants. Returns None when the script runs
    out (the agent treats None as a hard failure, matching the
    reference's server-down behavior)."""

    def __init__(self, responses: Sequence[str]):
        self.responses = list(responses)
        self.seen: List[List[dict]] = []
        self._i = 0

    def __call__(self, messages: List[dict]) -> Optional[str]:
        # deep-copy (minus image arrays) so the recorded history is a
        # true snapshot — the agent later edits text content in place
        # (_truncate_tool_tail) and a shallow copy would mutate it
        def snap(m):
            c = m.get("content")
            if not isinstance(c, list):
                return dict(m)
            return {**m, "content": [dict(x) if isinstance(x, dict)
                                     else x for x in c]}
        self.seen.append([snap(m) for m in messages])
        if self._i >= len(self.responses):
            return None
        out = self.responses[self._i]
        self._i += 1
        return out


class Sam3AgentClient:
    """segment(image, text_prompt) → outputs dict for the agent loop.

    Output schema mirrors the reference's service JSON
    (``client_sam3.py:41-47``): ``orig_img_h/w``, ``pred_boxes``
    normalized xywh, ``pred_scores`` descending, ``pred_masks`` as
    (H, W) bool arrays (in-memory analog of the RLE strings).
    """

    def __init__(self, processor, iom_thresh: float = 0.3,
                 min_mask_area: int = 5, mask_threshold: float = 0.0):
        self.processor = processor
        self.iom_thresh = float(iom_thresh)
        self.min_mask_area = int(min_mask_area)
        self.mask_threshold = float(mask_threshold)

    def __call__(self, image: np.ndarray, text_prompt: str) -> Dict:
        import cv2

        state = self.processor.set_image(image)
        res = self.processor.set_text_prompt(text_prompt, state)
        H, W = image.shape[:2]
        boxes = np.asarray(res.get("boxes_xyxy",
                                   np.zeros((0, 4), np.float32)))
        scores = np.asarray(res.get("scores", np.zeros((0,), np.float32)))
        low = np.asarray(res.get("masks_lowres",
                                 np.zeros((0, 4, 4), np.float32)))
        masks = []
        for m in low:
            up = cv2.resize(np.asarray(m, np.float32), (W, H),
                            interpolation=cv2.INTER_LINEAR)
            masks.append(up > self.mask_threshold)
        masks = (np.stack(masks) if masks
                 else np.zeros((0, H, W), bool))
        # degenerate-mask drop (reference: RLE strings shorter than 5
        # chars, i.e. near-empty masks). Explicit H*W: reshape(0, -1)
        # on an empty array raises (numpy cannot infer -1 from size 0)
        ok = masks.reshape(len(masks), H * W).sum(-1) >= self.min_mask_area
        boxes, scores, masks = boxes[ok], scores[ok], masks[ok]
        if len(masks) > 1:
            keep = remove_overlapping_masks(scores, masks, self.iom_thresh)
            boxes, scores, masks = boxes[keep], scores[keep], masks[keep]
        order = np.argsort(-scores, kind="stable")
        boxes, scores, masks = boxes[order], scores[order], masks[order]
        xywh = np.stack([boxes[:, 0] / W, boxes[:, 1] / H,
                         (boxes[:, 2] - boxes[:, 0]) / W,
                         (boxes[:, 3] - boxes[:, 1]) / H], -1) \
            if len(boxes) else np.zeros((0, 4), np.float32)
        return {"orig_img_h": int(H), "orig_img_w": int(W),
                "pred_boxes": [b.tolist() for b in xywh],
                "pred_scores": [float(s) for s in scores],
                "pred_masks": list(masks)}


def save_outputs(outputs: Dict, path: str) -> str:
    """Persist an outputs dict as JSON with COCO-RLE masks (the
    reference's on-disk format, ``call_sam_service`` step 1-3)."""
    from skix_torch.io.coco_export import mask_to_rle

    ser = dict(outputs)
    ser["pred_masks"] = [mask_to_rle(np.asarray(m)) for m
                         in outputs.get("pred_masks", [])]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(ser, f)
    return path
