"""SAM3 agent: an MLLM drives the open-vocabulary segmenter as a tool.

Port of ``skix/agent/`` (the reference's ``sam3/agent/``): the loop, the
renders and the LLM seam are host Python and numpy/cv2, as in skix; the
segmenter's detector forward runs on the card."""

from skix_torch.agent.client import LLMClient, Sam3AgentClient, ScriptedLLM
from skix_torch.agent.core import (AgentError, agent_inference, count_images,
                             parse_tool_call, prune_messages)
from skix_torch.agent.som import (mask_iom, remove_overlapping_masks,
                            render_set_of_marks, render_zoom_in)

__all__ = [
    "AgentError", "LLMClient", "Sam3AgentClient", "ScriptedLLM",
    "agent_inference", "count_images", "mask_iom", "parse_tool_call",
    "prune_messages", "remove_overlapping_masks", "render_set_of_marks",
    "render_zoom_in",
]
