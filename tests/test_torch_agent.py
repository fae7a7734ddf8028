"""skix_torch.agent against skix.agent on the CPU: the tool-call parser
over a table of responses, the prompts, the renders and the overlap
filter bit for bit, the pruning, the agent loop driven by one script and
one shared fake segmenter, and ``Sam3AgentClient`` over each package's
``Sam3Processor`` on the trained tiny detector fixture
(``tests/fixtures/tracker_tiny.npz``, ``Sam3Detector.tiny``: d_model 64)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import graft_geometry, jit0

import skix.agent as SA
import skix_torch.agent as PA
from skix.agent import client as SC
from skix_torch.agent import client as PC

FIXTURE = Path(__file__).parent / "fixtures" / "tracker_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))


def tool(name, **params):
    return (f"thinking...\n<tool>"
            f"{json.dumps({'name': name, 'parameters': params})}</tool>")


def _same(a, b, where="root"):
    """Messages, outputs and snapshots equal: dicts, lists and text equal,
    arrays bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_prompts_are_skix_character_for_character():
    from skix.agent import prompts as S
    from skix_torch.agent import prompts as P

    assert P.SYSTEM_PROMPT == S.SYSTEM_PROMPT
    assert P.ITERATIVE_CHECKING_PROMPT == S.ITERATIVE_CHECKING_PROMPT
    assert PA.__all__ == SA.__all__


PARSE_CASES = [
    'x <tool>{"name": "segment_phrase", "parameters": '
    '{"text_prompt": "skier"}}}</tool> <tool>junk</tool>',
    '<tool>{"name": "segment_phrase", "parameters": '
    '{"text_prompt": "the }}} sign"}}</tool>',
    "no tools here",
    "<tool>not json</tool>",
    '<tool>{"parameters": {}}</tool>',
    '<tool>["a", "b"]</tool>',
    '<tool>{"name": "report_no_mask"}</tool>',
    '<tool>{"name": "x", "parameters": {"a": 1}}}}</tool>',
    '<tool> {"name": "examine_each_mask", "parameters": {}} \n</tool>',
    'a <tool>{"name": "a"}</tool><tool>{"name": "b"}</tool>',
    '<tool>{"name": "select_masks_and_return", "parameters": '
    '{"final_answer_masks": [2, 1]}}',
]


@pytest.mark.parametrize("text", PARSE_CASES, ids=range(len(PARSE_CASES)))
def test_parse_tool_call_matches_skix(text):
    def run(mod):
        try:
            return ("ok", mod.parse_tool_call(text))
        except mod.AgentError as e:
            return ("error", str(e))
    assert run(PA) == run(SA)


def _masks(rng, n, hw, overlap=True):
    """``n`` rectangles, some overlapping, one empty."""
    H, W = hw
    m = np.zeros((n, H, W), bool)
    for i in range(n - 1):
        y0, x0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
        h, w = rng.integers(4, H // 2), rng.integers(4, W // 2)
        m[i, y0:y0 + h, x0:x0 + w] = True
    if overlap:
        m[1] |= m[0]
    return m


def test_renders_iom_and_overlap_filter_match_skix_bitwise():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (72, 96, 3)).astype(np.uint8)
    masks = _masks(rng, 6, (72, 96))
    scores = rng.random(6)
    scores[3] = scores[2]                         # a tie: the stable order
    _same(PA.mask_iom(masks, masks[:3]), SA.mask_iom(masks, masks[:3]))
    for thresh in (0.0, 0.3, 0.9):
        _same(PA.remove_overlapping_masks(scores, masks, thresh),
              SA.remove_overlapping_masks(scores, masks, thresh))
    _same(PA.remove_overlapping_masks([0.5], masks[:1]),
          SA.remove_overlapping_masks([0.5], masks[:1]))
    low = masks[:, ::2, ::2]                      # another resolution
    for kw in ({}, {"draw_labels": False}, {"alpha": 0.7}):
        _same(PA.render_set_of_marks(image, list(masks), **kw),
              SA.render_set_of_marks(image, list(masks), **kw))
    _same(PA.render_set_of_marks(image / 255.0, list(low)),
          SA.render_set_of_marks(image / 255.0, list(low)))
    for m in list(masks) + [low[0], np.ones((72, 96), bool)]:
        _same(PA.render_zoom_in(image, m), SA.render_zoom_in(image, m))
    _same(PA.render_zoom_in(image, masks[0], color=(10, 200, 30),
                            out_long_side=128),
          SA.render_zoom_in(image, masks[0], color=(10, 200, 30),
                            out_long_side=128))


class FakeSegmenter:
    """prompt → canned outputs (the same for both packages)."""

    def __init__(self, by_prompt):
        self.by_prompt = by_prompt

    def __call__(self, image, prompt):
        H, W = image.shape[:2]
        masks = self.by_prompt.get(prompt, np.zeros((0, H, W), bool))
        n = len(masks)
        return {"orig_img_h": H, "orig_img_w": W,
                "pred_boxes": [[0.1 * i, 0.1, 0.2, 0.2] for i in range(n)],
                "pred_scores": [0.9 - 0.1 * i for i in range(n)],
                "pred_masks": list(masks)}


ACCEPT, REJECT = "<verdict>Accept</verdict>", "ok <verdict>Reject</verdict>"
SCRIPTS = {
    "select": [tool("segment_phrase", text_prompt="skier"),
               tool("select_masks_and_return", final_answer_masks=[3, 1, 9])],
    "examine_duplicate_retry": [
        tool("segment_phrase", text_prompt="skier"),
        tool("examine_each_mask"), ACCEPT, REJECT, ACCEPT,
        tool("segment_phrase", text_prompt="skier"),
        tool("segment_phrase", text_prompt="person"),
        tool("select_masks_and_return", final_answer_masks=[1, 2])],
    "no_masks_then_examine_twice": [
        tool("segment_phrase", text_prompt="tree"),
        tool("segment_phrase", text_prompt="skier"),
        tool("examine_each_mask"), ACCEPT, ACCEPT, REJECT,
        tool("examine_each_mask"), ACCEPT, REJECT,
        tool("examine_each_mask"), REJECT,
        tool("segment_phrase", text_prompt="person"),
        tool("select_masks_and_return", final_answer_masks=[2])],
    "report": [tool("report_no_mask")],
    "bad_first_call": [tool("examine_each_mask")],
    "unknown_tool": [tool("segment_phrase", text_prompt="skier"),
                     tool("fly")],
    "bad_verdict": [tool("segment_phrase", text_prompt="skier"),
                    tool("examine_each_mask"), "maybe"],
    "runs_out": [tool("segment_phrase", text_prompt="skier")],
    "bad_indices": [tool("segment_phrase", text_prompt="skier"),
                    tool("select_masks_and_return",
                         final_answer_masks=["a"])],
    "max_generations": [tool("segment_phrase", text_prompt=f"p{i}")
                        for i in range(6)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_agent_loop_matches_skix(name, tmp_path):
    """One script and one fake segmenter: the same messages, the same
    ``seen`` snapshots, the same final outputs and rendered image (or the
    same AgentError), and the same files under ``output_dir``."""
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    seg = FakeSegmenter({"skier": _masks(rng, 3, (48, 64), overlap=False),
                         "person": _masks(rng, 2, (48, 64))})
    results = {}
    for side, mod, client in (("skix", SA, SC), ("port", PA, PC)):
        llm = client.ScriptedLLM(SCRIPTS[name])
        try:
            out = mod.agent_inference(
                image, "the skier", llm, seg,
                max_generations=3 if name == "max_generations" else 100,
                output_dir=str(tmp_path / side))
        except mod.AgentError as e:
            out = ("error", str(e))
        files = sorted(p.name for p in (tmp_path / side).glob("*.json"))
        results[side] = (out, llm.seen, files, [
            json.loads((tmp_path / side / f).read_text()) for f in files])
    _same(results["port"], results["skix"])


def test_prune_messages_matches_skix():
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)

    def msgs():
        user = {"role": "user", "content": [{"type": "image", "image": image},
                                            {"type": "text", "text": "q"}]}
        out = [{"role": "system", "content": "sys"}, user]
        for i in range(5):
            out.append({"role": "assistant", "content": [{
                "type": "text", "text": tool("segment_phrase",
                                             text_prompt=f"p{i}")
                if i in (1, 3) else tool("examine_each_mask")}]})
            out.append({"role": "user", "content": [
                {"type": "text", "text": f"r{i}"},
                {"type": "image", "image": image + i}]})
        return out
    for tail in (3, 6, 11):
        for used in ([], ["p3"], ["p1", "p3"]):
            _same(PA.prune_messages(msgs()[:tail], used, "p3", image, "q"),
                  SA.prune_messages(msgs()[:tail], used, "p3", image, "q"))
    assert PA.count_images(msgs()) == SA.count_images(msgs()) == 6


@pytest.fixture(scope="module")
def processors():
    """skix's and the port's Sam3Processor on the fixture detector with the
    same grafted geometry branch; skix's forward at XLA's level 0."""
    import make_tracker_fixture as mtf
    from skix.tracking.image_processor import Sam3Processor as Skix
    from skix.tracking.sam3_detector import Sam3Detector as SkixDet
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.tracking.image_processor import Sam3Processor
    from skix_torch.tracking.sam3_detector import Sam3Detector

    det_vars = graft_geometry(mtf.load_fixture(FIXTURE)[0])
    port = Sam3Detector.tiny(img_size=112, geometry=True)
    load_into(port, flax_to_state_dict(det_vars))
    sk = Skix(SkixDet.tiny(img_size=112), det_vars)
    sk._fwd = jit0(sk._forward)
    return sk, Sam3Processor(port.eval())


def test_agent_client_matches_skix(processors, tmp_path):
    """``Sam3AgentClient`` over each processor at a threshold between two
    of skix's scores: the same kept queries in the same order, scores and
    boxes within 1e-4, ≤ 1e-3 of mask pixels different; ``save_outputs``
    writes the same JSON; an empty result keeps its shapes."""
    import make_tracker_fixture as mtf

    sk, pp = processors
    frame = mtf.synth_scene(3, n_obj=3)[0]
    image = (np.pad(frame, ((0, 40), (0, 8), (0, 0))) * 255).astype(np.uint8)
    scores = np.sort(sk.set_text_prompt("person", sk.set_image(image))
                     ["all_scores"])
    threshold = float(scores[-6] + scores[-7]) / 2
    assert min(abs(scores - threshold)) > 1e-4
    outs = {}
    for side, proc, client in (("skix", sk, SC), ("port", pp, PC)):
        proc.set_confidence_threshold(threshold)
        outs[side] = client.Sam3AgentClient(proc, min_mask_area=1)(
            image, "person")
    got, want = outs["port"], outs["skix"]
    assert len(want["pred_masks"]) >= 2
    assert (got["orig_img_h"], got["orig_img_w"]) == (want["orig_img_h"],
                                                      want["orig_img_w"])
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"],
                               atol=1e-4, rtol=0)
    g, w = np.stack(got["pred_masks"]), np.stack(want["pred_masks"])
    assert g.shape == w.shape and g.dtype == w.dtype == bool
    assert (g != w).mean() <= 1e-3
    for side, mod in (("skix", SC), ("port", PC)):
        mod.save_outputs(outs["skix"], str(tmp_path / side / "o.json"))
    assert ((tmp_path / "port" / "o.json").read_text()
            == (tmp_path / "skix" / "o.json").read_text())
    for proc in (sk, pp):
        proc.set_confidence_threshold(2.0)
    empty = [c.Sam3AgentClient(p)(image, "person")
             for p, c in ((pp, PC), (sk, SC))]
    _same(empty[0], empty[1])
    assert empty[0]["pred_masks"] == []
