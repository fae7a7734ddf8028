"""SAM3 agent loop: an MLLM drives the segmenter as a tool.

Capability parity with the reference's agent
(``sam3/agent/agent_core.py:120 agent_inference``): four tools —
``segment_phrase`` (open-vocabulary segmentation with a noun phrase,
duplicate prompts rejected, ``:225-250``), ``examine_each_mask``
(per-mask Accept/Reject verification through a second "iterative
checking" conversation with a zoomed-in render, ``:296-380``),
``select_masks_and_return`` (1-based index selection, deduped and
validated, ``:455-490``), and ``report_no_mask`` (``:495``). Between
rounds the message history is pruned to the first two messages plus the
latest segment_phrase call onward with a previously-used-prompts
warning (``:54 _prune_messages_for_next_round``), keeping ≤2 images in
context (``:540 count_images`` assert).

A copy of ``skix/agent/core.py``. As in skix, images and masks travel
as in-memory numpy arrays (message content ``{"type": "image", "image":
<ndarray>}``); the segmenter and LLM are injected callables
(`skix_torch.agent.client`); file I/O is opt-in via ``output_dir``. The
state machine itself is host-side Python — the card's work happens inside
the segmenter's detector forward.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from skix_torch.agent.prompts import ITERATIVE_CHECKING_PROMPT, SYSTEM_PROMPT
from skix_torch.agent.som import render_set_of_marks, render_zoom_in

Segmenter = Callable[[np.ndarray, str], Dict]


class AgentError(ValueError):
    """Protocol violation or LLM failure inside the agent loop."""


def count_images(messages: List[dict]) -> int:
    """Total images in a message history (reference ``count_images``)."""
    total = 0
    for msg in messages:
        content = msg.get("content")
        if isinstance(content, list):
            total += sum(1 for c in content
                         if isinstance(c, dict) and c.get("type") == "image")
    return total


def parse_tool_call(text: str) -> Tuple[str, dict]:
    """Extract the FIRST ``<tool>{json}</tool>`` block (the reference
    truncates everything after the first ``</tool>`` because MLLMs
    sometimes emit several calls at once)."""
    if "<tool>" not in text:
        raise AgentError(f"no <tool> block in response: {text[:200]!r}")
    payload = text.split("</tool>", 1)[0].split("<tool>")[-1].strip()
    try:
        call = json.loads(payload)
    except json.JSONDecodeError:
        # LLMs sometimes append a stray closing brace; retry with ONE
        # trailing brace trimmed (a global '}}}'→'}}' replace would
        # corrupt valid payloads containing triple braces in strings)
        try:
            call = json.loads(payload.rstrip()[:-1]) \
                if payload.rstrip().endswith("}") else None
        except json.JSONDecodeError:
            call = None
        if call is None:
            raise AgentError(f"invalid JSON in tool call: {payload!r}") \
                from None
    if not isinstance(call, dict) or "name" not in call:
        raise AgentError(f"tool call missing 'name': {call!r}")
    return call["name"], call.get("parameters", {})


def _param(params: dict, key: str):
    """Required tool parameter — missing keys are protocol violations
    (AgentError), not raw KeyErrors."""
    if not isinstance(params, dict) or key not in params:
        raise AgentError(f"tool call missing parameter {key!r}: {params!r}")
    return params[key]


def _user_msg(*content) -> dict:
    return {"role": "user", "content": list(content)}


def _text(t: str) -> dict:
    return {"type": "text", "text": t}


def _image(arr: np.ndarray) -> dict:
    return {"type": "image", "image": arr}


def _truncate_tool_tail(messages: List[dict]) -> None:
    """Clip every assistant text at its first ``</tool>`` in place."""
    for msg in messages:
        if msg.get("role") != "assistant":
            continue
        for c in msg.get("content", []):
            if isinstance(c, dict) and c.get("type") == "text":
                c["text"] = c["text"].split("</tool>", 1)[0] + "</tool>\n\n"


def prune_messages(messages: List[dict], used_prompts: List[str],
                   latest_prompt: str, image: np.ndarray,
                   query: str) -> List[dict]:
    """Three-part pruning (reference ``_prune_messages_for_next_round``):
    keep messages[:2]; keep the latest assistant message containing a
    segment_phrase tool call and everything after it; if prompts other
    than the latest were already tried, rebuild message 2 with a
    do-not-reuse warning.

    Deviation from the reference: instead of asserting the history stays
    under 10 entries (repeated ``examine_each_mask`` rounds after one
    segment call legitimately grow the post-anchor tail by 2 each), an
    over-long tail is compressed to its first and last exchange — the
    newest render is what the model acts on."""
    part1 = [messages[0], dict(messages[1])]
    start = None
    for idx in range(len(messages) - 1, 1, -1):
        msg = messages[idx]
        if msg.get("role") != "assistant":
            continue
        for c in msg.get("content", []):
            if (isinstance(c, dict) and c.get("type") == "text"
                    and "<tool>" in c.get("text", "")
                    and "segment_phrase" in c.get("text", "")):
                start = idx
                break
        if start is not None:
            break
    part2 = list(messages[start:]) if start is not None else []
    if len(part2) > 6:
        part2 = part2[:2] + part2[-2:]
    # the ≤2-image budget: message 2 carries the raw image, so at most
    # ONE kept tail message may carry one — strip images from all but
    # the last image-bearing entry
    img_idx = [i for i, m in enumerate(part2) if count_images([m])]
    for i in img_idx[:-1]:
        part2[i] = {**part2[i],
                    "content": [c for c in part2[i]["content"]
                                if not (isinstance(c, dict)
                                        and c.get("type") == "image")]}
    previously = [p for p in used_prompts if p != latest_prompt]
    if part2 and previously:
        warning = (f"Previously tried segment_phrase text_prompts, none "
                   f"satisfactory — never reuse any of: {previously}.")
        part1[1] = _user_msg(
            _image(image),
            _text(f"The above image is the raw input image. The user "
                  f"query is: '{query}'. {warning}"))
    return part1 + part2


def _verify_one_mask(llm, image: np.ndarray, query: str, overlay, zoomed,
                     ) -> bool:
    """One iterative-checking conversation → Accept?  (reference
    ``agent_core.py:330-380``)."""
    msgs = [
        {"role": "system", "content": ITERATIVE_CHECKING_PROMPT},
        _user_msg(_text("The raw input image:"), _image(image),
                  _text(f"The user query is: '{query}'"),
                  _text("Image with the candidate mask rendered on it:"),
                  _image(overlay),
                  _text("Zoomed-in view of the mask:"), _image(zoomed)),
    ]
    reply = llm(msgs)
    if reply is None:
        raise AgentError("verifier LLM returned None")
    verdict = reply.split("<verdict>")[-1].split("</verdict>")[0].strip()
    if "Accept" in verdict and "Reject" not in verdict:
        return True
    if "Reject" in verdict and "Accept" not in verdict:
        return False
    raise AgentError(f"unparseable verdict: {reply!r}")


def _subset(outputs: Dict, idx: List[int]) -> Dict:
    return {"orig_img_h": outputs["orig_img_h"],
            "orig_img_w": outputs["orig_img_w"],
            "pred_boxes": [outputs["pred_boxes"][i] for i in idx],
            "pred_scores": [outputs["pred_scores"][i] for i in idx],
            "pred_masks": [outputs["pred_masks"][i] for i in idx]}


def agent_inference(image: np.ndarray, query: str, llm,
                    segmenter: Segmenter, max_generations: int = 100,
                    output_dir: Optional[str] = None,
                    ) -> Tuple[List[dict], Dict, np.ndarray]:
    """Run the agent loop. Returns (messages, final_outputs, rendered).

    ``final_outputs``: {orig_img_h/w, pred_boxes normalized xywh,
    pred_scores, pred_masks (H, W) bool arrays}; ``rendered`` is the
    set-of-marks overlay of the final masks (the raw image when empty).
    """
    image = np.asarray(image)
    used_prompts: List[str] = []
    latest_prompt = ""
    outputs: Optional[Dict] = None
    generations = 0

    messages = [
        {"role": "system", "content": SYSTEM_PROMPT},
        _user_msg(_image(image),
                  _text(f"The above image is the raw input image. The "
                        f"user query is: '{query}'.")),
    ]

    def render(out: Dict) -> np.ndarray:
        return (render_set_of_marks(image, out["pred_masks"])
                if out["pred_masks"] else image.copy())

    def maybe_save(out: Dict, tag: str) -> None:
        if output_dir:
            from skix_torch.agent.client import save_outputs
            save_outputs(out, os.path.join(output_dir, f"{tag}.json"))

    text = llm(messages)
    while text is not None:
        name, params = parse_tool_call(text)
        assistant = {"role": "assistant", "content": [_text(text)]}
        if outputs is None and name not in ("segment_phrase",
                                            "report_no_mask"):
            raise AgentError(
                f"first tool call must be segment_phrase or "
                f"report_no_mask, got {name}")

        if name == "segment_phrase":
            prompt = str(_param(params, "text_prompt"))
            messages.append(assistant)
            if prompt in used_prompts:
                messages.append(_user_msg(_text(
                    f"You already used '{prompt}' as a text_prompt; it "
                    f"may not be reused. Call segment_phrase with a "
                    f"different, perhaps more general noun phrase. Never "
                    f"use any of: {used_prompts}.")))
            else:
                used_prompts.append(prompt)
                latest_prompt = prompt
                outputs = segmenter(image, prompt)
                maybe_save(outputs, f"segment_{len(used_prompts)}")
                n = len(outputs["pred_masks"])
                if n == 0:
                    messages.append(_user_msg(_text(
                        f"segment_phrase produced no masks for "
                        f"'{prompt}'. Try a different, perhaps more "
                        f"general noun phrase. The original user query "
                        f"was '{query}'.")))
                else:
                    messages.append(_user_msg(
                        _text(f"segment_phrase produced {n} mask(s), "
                              f"all rendered with 1-based numbers in "
                              f"the image below. Compare them against "
                              f"the raw image and the user query "
                              f"'{query}', then choose your next "
                              f"action."),
                        _image(render(outputs))))

        elif name == "examine_each_mask":
            if not latest_prompt or outputs is None:
                raise AgentError("examine_each_mask before any "
                                 "segment_phrase result")
            # replace the trailing render message with a text-only one
            # so the two verifier images fit the ≤2-image budget
            if (messages and messages[-1]["role"] == "user"
                    and count_images([messages[-1]])):
                messages.pop()
                messages.append(_user_msg(_text(
                    "segment_phrase produced several masks; they are "
                    "being examined one by one.")))
            keep = []
            for i, mask in enumerate(outputs["pred_masks"]):
                overlay = render_set_of_marks(image, [mask],
                                              draw_labels=False)
                zoomed = render_zoom_in(image, mask)
                if _verify_one_mask(llm, image, query, overlay, zoomed):
                    keep.append(i)
            outputs = _subset(outputs, keep)
            maybe_save(outputs, f"examined_{len(used_prompts)}")
            messages.append(assistant)
            if not keep:
                messages.append(_user_msg(_text(
                    f"examine_each_mask rejected every mask. Call "
                    f"segment_phrase again with a different noun "
                    f"phrase. The original user query was '{query}'.")))
            else:
                messages.append(_user_msg(
                    _text(f"After examine_each_mask, {len(keep)} mask(s) "
                          f"remain, rendered below. The original user "
                          f"query was '{query}'."),
                    _image(render(outputs))))

        elif name == "select_masks_and_return":
            if outputs is None:
                raise AgentError("select before any segmentation")
            wanted = _param(params, "final_answer_masks")
            try:
                wanted = [int(i) for i in wanted]
            except (TypeError, ValueError) as e:
                raise AgentError(
                    f"final_answer_masks must be integers: {wanted!r}"
                ) from e
            avail = set(range(1, len(outputs["pred_masks"]) + 1))
            picked = sorted({i for i in wanted if i in avail})
            final = _subset(outputs, [i - 1 for i in picked])
            messages.append(assistant)
            maybe_save(final, "final")
            return messages, final, render(final)

        elif name == "report_no_mask":
            H, W = image.shape[:2]
            final = {"orig_img_h": int(H), "orig_img_w": int(W),
                     "pred_boxes": [], "pred_scores": [],
                     "pred_masks": []}
            messages.append(assistant)
            maybe_save(final, "final")
            return messages, final, image.copy()

        else:
            raise AgentError(f"unknown tool: {name}")

        _truncate_tool_tail(messages)
        messages = prune_messages(messages, used_prompts, latest_prompt,
                                  image, query)
        if count_images(messages) > 2:   # hard invariant, not an assert
            raise AgentError("image budget exceeded after pruning")
        generations += 1
        if generations > max_generations:
            raise AgentError(
                f"exceeded max_generations ({max_generations})")
        text = llm(messages)

    raise AgentError("LLM returned None mid-conversation")
