"""skix_torch's geometric prompts of the detector against skix on the CPU:
``bilinear_sample`` and ``box_grid_sample`` at the image border, the
``GeometryPromptEncoder``, the detector on the committed trained
``tests/fixtures/tracker_tiny.npz`` with a grafted geometry branch (text ‖
geometry, geometry only, every slot invalid), ``Sam3Processor``'s request
sequence (text → box → point → negative point → threshold → reset, then
geometry alone on the ``"visual"`` text prompt) and its text prompt
through a tiny CLIP tower, the loading rule of the ``geometry`` flag, the
encoders that the processor and the session keep for a detector without
the branch, and the video session's box-level path with geometry.

skix draws a missing geometry branch with ``jax.random``; the file grafts
it once with skix's init (``_torch_parity.graft_geometry``) and gives both
packages that tree. Tolerances: float32 outputs to 1e-4 of their scale;
the processor's keep sets equal (no score within 1e-5 of a threshold);
sampling to 1e-6.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from _torch_parity import (_CHEAP, close_scaled, graft_geometry, jit0,
                          port_variables, random_variables)

from skix_torch.convert import flax_to_state_dict, load_into

FIXTURE = Path(__file__).parent / "fixtures" / "tracker_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))


@pytest.fixture(scope="module")
def detectors():
    """(skix's tiny detector, the fixture's tree with the grafted branch,
    the port's detector built with ``geometry=True`` carrying it)."""
    import make_tracker_fixture as mtf
    from skix.tracking.sam3_detector import Sam3Detector as SkixDet
    from skix_torch.tracking.sam3_detector import Sam3Detector

    det_vars = graft_geometry(mtf.load_fixture(FIXTURE)[0])
    port = Sam3Detector.tiny(img_size=112, geometry=True)
    load_into(port, flax_to_state_dict(det_vars))
    return SkixDet.tiny(img_size=112), det_vars, port.eval()


def _slots(r, B=1, Np=8, Nb=4):
    """Random point and box slots, some invalid, labels −1..2 (clipped to
    0/1 by the encoder)."""
    pts = r.random((B, Np, 2)).astype(np.float32)
    bxs = np.concatenate([r.uniform(0.2, 0.8, (B, Nb, 2)),
                          r.uniform(0.1, 0.6, (B, Nb, 2))], -1
                         ).astype(np.float32)
    return (pts, r.integers(-1, 3, (B, Np)).astype(np.int32),
            r.random((B, Np)) < 0.6, bxs,
            r.integers(0, 2, (B, Nb)).astype(np.int32),
            r.random((B, Nb)) < 0.6)


def test_sampling_at_the_border_matches_skix():
    """skix's own bilinear gather (floor, clipped taps, blend) at the
    corners, on the edges and outside [0, 1]; box grids that cross the
    border."""
    from skix.tracking import sam3_detector as S
    from skix_torch.tracking import sam3_detector as P

    r = np.random.default_rng(0)
    feat = r.normal(size=(6, 8, 5)).astype(np.float32)
    pts = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [0, 0.5],
                    [0.999, 0.001], [1.3, -0.2], [-0.1, 1.1],
                    [(1 + 0.5) / 8, (2 + 0.5) / 6]], np.float32)
    boxes = np.array([[0.05, 0.05, 0.2, 0.3], [0.95, 0.9, 0.3, 0.4],
                      [0.5, 0.5, 1.2, 1.2], [0.0, 1.0, 0.1, 0.1]], np.float32)
    want_p = np.asarray(jit0(S.bilinear_sample)(feat, pts))
    want_b = np.asarray(jit0(S.box_grid_sample)(feat, boxes))
    got_p = P.bilinear_sample(torch.as_tensor(feat), torch.as_tensor(pts))
    got_b = P.box_grid_sample(torch.as_tensor(feat), torch.as_tensor(boxes))
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_p[-1].numpy(), feat[2, 1])


def test_geometry_encoder_matches_skix():
    """Tokens and pad mask with some slots invalid, and with every slot
    invalid (zero tokens, all padded)."""
    from skix.tracking.sam3_detector import GeometryPromptEncoder as Skix
    from skix_torch.tracking.sam3_detector import GeometryPromptEncoder

    r = np.random.default_rng(1)
    port = GeometryPromptEncoder(d_model=16, max_points=4, max_boxes=2)
    v = port_variables(port, 2)
    m = Skix(d_model=16, max_points=4, max_boxes=2)
    apply = jit0(m.apply)
    feat = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    slots = list(_slots(r, 2, 4, 2))
    for case in ("some_invalid", "all_invalid"):
        if case == "all_invalid":
            slots[2], slots[5] = slots[2] & False, slots[5] & False
        tok, pad = apply(v, feat, *slots)
        with torch.no_grad():
            got_tok, got_pad = port(*(torch.as_tensor(x)
                                      for x in (feat, *slots)))
        close_scaled(got_tok.numpy(), np.asarray(tok), 1e-4)
        np.testing.assert_array_equal(got_pad.numpy(), np.asarray(pad))
    assert not got_tok.abs().max() and got_pad.all()


def test_geometry_only_detection_matches_skix(detectors):
    """No text prompt: the prompt is the geometry tokens alone (no null
    prompt), a batch of two images."""
    m, v, port = detectors
    r = np.random.default_rng(3)
    img = r.random((2, 112, 112, 3)).astype(np.float32)
    slots = _slots(r, 2)
    keys = ("points", "point_labels", "point_valid", "boxes", "box_labels",
            "box_valid")
    want = jit0(lambda v, im, *g: m.apply(v, im, None, **dict(zip(keys, g))))(
        v, img, *slots)
    with torch.no_grad():
        got = port(torch.as_tensor(img), **{k: torch.as_tensor(x)
                                             for k, x in zip(keys, slots)})
    for field in ("boxes_cxcywh", "scores", "mask_logits", "embeddings",
                  "presence"):
        close_scaled(getattr(got, field).numpy(),
                     np.asarray(getattr(want, field)), 1e-4)


@pytest.fixture(scope="module")
def skix_forward(detectors):
    """skix's processor forward at XLA's level 0, shared by the processor
    twins: their prompts have one shape (4 text tokens), so one compile."""
    from skix.tracking.image_processor import Sam3Processor as Skix

    m, v, _ = detectors
    return jit0(Skix(m, v)._forward)


def _same_results(got, want, threshold):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["all_scores"] >= threshold,
                                  want["all_scores"] >= threshold)
    assert np.abs(want["all_scores"] - threshold).min() > 1e-5
    for k in ("all_scores", "scores", "presence", "all_boxes_xyxy",
              "boxes_xyxy", "masks_lowres"):
        assert np.shape(got[k]) == np.shape(want[k]), k
        if np.size(want[k]):
            close_scaled(got[k], want[k], 1e-4)


def test_processor_sequence_matches_skix(detectors, skix_forward):
    """text → +box → +point → +negative point → a threshold change →
    reset → a box alone (the "visual" text prompt): every result, keep sets
    equal; the text-only step runs text ‖ all-invalid slots."""
    import make_tracker_fixture as mtf
    from skix.tracking.image_processor import Sam3Processor as Skix
    from skix_torch.tracking.image_processor import Sam3Processor

    m, v, port = detectors
    frame = mtf.synth_scene(7, n_obj=2)[0]
    image = (np.pad(frame, ((0, 0), (0, 48), (0, 0))) * 255).astype(np.uint8)
    sk = Skix(m, v, confidence_threshold=0.3)
    sk._fwd = skix_forward
    pp = Sam3Processor(port, confidence_threshold=0.3)
    ss, ps = sk.set_image(image), pp.set_image(image)
    steps = [lambda p, s: p.set_text_prompt("person", s),
             lambda p, s: p.add_geometric_prompt([0.4, 0.5, 0.3, 0.4], True,
                                                 s),
             lambda p, s: p.add_point_prompt([0.3, 0.6], True, s),
             lambda p, s: p.add_point_prompt([0.8, 0.2], False, s)]
    for step in steps:
        _same_results(step(pp, ps), step(sk, ss), 0.3)
    assert ps.points.shape == (2, 2) and ps.boxes.shape == (1, 4)
    top = np.sort(ss.results["all_scores"])
    threshold = float(top[-3] + top[-4]) / 2
    _same_results(pp.set_confidence_threshold(threshold, ps),
                  sk.set_confidence_threshold(threshold, ss), threshold)
    assert len(ps.results["scores"]) == 3
    for p, s in ((pp, ps), (sk, ss)):
        p.reset_all_prompts(s)
        assert s.results is None and s.boxes is None and s.text_memory is None
    _same_results(pp.add_geometric_prompt([0.5, 0.5, 0.3, 0.3], True, ps),
                  sk.add_geometric_prompt([0.5, 0.5, 0.3, 0.3], True, ss),
                  threshold)
    assert ps.text_memory is not None          # the "visual" prompt
    assert pp.set_confidence_threshold(0.5) is None


def test_processor_clip_prompt_matches_skix(detectors, skix_forward):
    """``set_text_prompt`` through a tiny CLIP tower (width 32, one layer,
    context 4, the full vocabulary; each package's tokenizer: start,
    "skier", end, one pad) in place of the hash embedding, then a
    threshold that keeps three queries, then a box: every result, keep
    sets and pad masks equal."""
    import jax.numpy as jnp
    import make_tracker_fixture as mtf
    from skix.tracking.clip_text import VETextEncoder as SkixVE
    from skix.tracking.clip_tokenizer import ClipTokenizer as SkixTokenizer
    from skix.tracking.image_processor import Sam3Processor as Skix
    from skix_torch.tracking.clip_text import VETextEncoder
    from skix_torch.tracking.clip_tokenizer import ClipTokenizer
    from skix_torch.tracking.image_processor import Sam3Processor

    m, v, port = detectors
    clip = dict(d_model=64, width=32, heads=2, layers=1, context_length=4,
                vocab_size=49408)
    enc = SkixVE(**clip)
    clip_v = random_variables(enc, np.random.default_rng(8),
                              jnp.zeros((1, 4), jnp.int32))
    port_enc = VETextEncoder(**clip)
    assert load_into(port_enc, flax_to_state_dict(clip_v)) == []
    sk = Skix(m, v, clip=(SkixTokenizer(context_length=4), enc, clip_v),
              confidence_threshold=0.3)
    sk._fwd = skix_forward
    pp = Sam3Processor(port, clip=(ClipTokenizer(context_length=4),
                                   port_enc.eval()),
                       confidence_threshold=0.3)
    image = (mtf.synth_scene(7, n_obj=2)[0] * 255).astype(np.uint8)
    ss, ps = sk.set_image(image), pp.set_image(image)
    _same_results(pp.set_text_prompt("skier", ps),
                  sk.set_text_prompt("skier", ss), 0.3)
    np.testing.assert_array_equal(ps.text_pad.numpy(),
                                  np.asarray(ss.text_pad))
    assert ps.text_pad.tolist() == [[False, False, False, True]]
    top = np.sort(ss.results["all_scores"])
    threshold = float(top[-3] + top[-4]) / 2
    _same_results(pp.set_confidence_threshold(threshold, ps),
                  sk.set_confidence_threshold(threshold, ss), threshold)
    assert len(ps.results["scores"]) == 3
    _same_results(pp.add_geometric_prompt([0.4, 0.5, 0.3, 0.4], True, ps),
                  sk.add_geometric_prompt([0.4, 0.5, 0.3, 0.4], True, ss),
                  threshold)


def test_loading_rule():
    """A tree without the geometry branch (the committed fixture's) loads
    into a detector built without it, whose geometry call raises naming
    the flag, and not into one built with it; an encoder made for it
    (the same seed, the same weights) runs the call, and the detector
    stays without the branch; a tree with the branch loads into a detector
    built with it."""
    from skix_torch.tracking.fixture import fixture_variables
    from skix_torch.tracking.sam3_detector import Sam3Detector

    det_vars, _ = fixture_variables(FIXTURE)
    sd = flax_to_state_dict(det_vars)
    assert not any(k.startswith("geometry_encoder") for k in sd)
    with pytest.raises(KeyError, match="geometry_encoder"):
        load_into(Sam3Detector.tiny(img_size=112, geometry=True), sd)
    det = Sam3Detector.tiny(img_size=112)
    assert load_into(det, sd) == []
    img = torch.zeros(1, 112, 112, 3)
    with pytest.raises(ValueError, match="geometry=True"):
        det(img, None, points=torch.zeros(1, 8, 2))
    made = [det.make_geometry_encoder(torch.Generator().manual_seed(4))
            for _ in range(2)]
    for a, b in zip(made[0].state_dict().values(),
                    made[1].state_dict().values()):
        assert torch.equal(a, b)
    with torch.no_grad():
        out = det.eval()(img, None, boxes=torch.full((1, 4, 4), 0.5),
                         box_valid=torch.ones(1, 4, dtype=torch.bool),
                         geometry_encoder=made[0])
    assert torch.isfinite(out.scores).all()
    assert det.geometry_encoder is None and det.state_dict().keys() == sd.keys()
    full = Sam3Detector.tiny(img_size=112, geometry=True)
    assert load_into(full, {**sd, **{f"geometry_encoder.{k}": t for k, t in
                                     made[0].state_dict().items()}}) == []


def test_prompting_leaves_the_detector_as_it_was():
    """Two processors and a session with different seeds on one detector
    built without the geometry branch: each keeps an encoder of its own
    (one seed, one encoder; two seeds, two encoders and two results), and
    the detector's parameters and ``state_dict`` stay as they were; a
    detector with the branch lends it to the processor."""
    from skix_torch.tracking.fixture import load_tracker_fixture
    from skix_torch.tracking.image_processor import Sam3Processor
    from skix_torch.tracking.sam3_detector import Sam3Detector
    from skix_torch.tracking.session import VideoPredictor

    det = load_tracker_fixture(FIXTURE, device="cpu")[0]
    before = {k: t.clone() for k, t in det.state_dict().items()}
    procs = [Sam3Processor(det, rng_seed=seed) for seed in (0, 5, 0)]
    image = np.full((60, 80, 3), 128, np.uint8)
    results = []
    for p in procs:
        st = p.set_image(image)
        results.append(p.add_geometric_prompt([0.5, 0.5, 0.4, 0.4], True,
                                              st)["all_scores"])
    weights = [torch.cat([t.flatten() for t in p.geometry_encoder
                          .state_dict().values()]) for p in procs]
    assert torch.equal(weights[0], weights[2])
    assert not torch.equal(weights[0], weights[1])
    np.testing.assert_array_equal(results[0], results[2])
    assert np.abs(results[0] - results[1]).max() > 1e-4
    vp = VideoPredictor(det, smoke_prompts=True, rng_seed=5)
    sid = vp.start_session(np.zeros((2, 60, 80, 3), np.uint8))
    vp.add_prompt(sid, frame_idx=0, points=[[30, 20]])
    assert vp.geometry_encoder is not procs[1].geometry_encoder
    assert torch.equal(torch.cat([t.flatten() for t in vp.geometry_encoder
                                  .state_dict().values()]), weights[1])
    assert det.geometry_encoder is None
    assert det.state_dict().keys() == before.keys()
    for k, t in det.state_dict().items():
        assert torch.equal(t, before[k]), k
    full = Sam3Detector.tiny(img_size=112, geometry=True)
    assert Sam3Processor(full).geometry_encoder is full.geometry_encoder


def test_box_session_with_geometry_matches_skix(detectors):
    """The video session's box-level path (a Sam3Detector without a
    tracker): batches of two frames through ``_detect_batch``, the prompted
    frame's slots beside all-invalid ones, the lifecycle on the boxes."""
    import make_tracker_fixture as mtf
    from skix.tracking.lifecycle import TrackerConfig as SkixCfg
    from skix.tracking.session import VideoPredictor as Skix
    from skix_torch.tracking.lifecycle import TrackerConfig
    from skix_torch.tracking.session import VideoPredictor

    m, v, port = detectors
    cfg = dict(max_objects=4, det_score_threshold=0.0)
    sk = Skix(m, v, tracker_cfg=SkixCfg(**cfg), batch_size=2,
              smoke_prompts=True)
    sk._detect = jax.jit(sk._detect_batch, compiler_options=_CHEAP)
    sk._step = jax.jit(sk._step.__wrapped__, compiler_options=_CHEAP)
    pp = VideoPredictor(port, tracker_cfg=TrackerConfig(**cfg), batch_size=2,
                        smoke_prompts=True)
    frames = (mtf.synth_clip(20_001, T=3, n_obj=2)[0] * 255).astype(np.uint8)
    outs = []
    for p in (sk, pp):
        sid = p.start_session(frames)
        p.add_prompt(sid, "person", frame_idx=1,
                     boxes_xyxy=[[20, 20, 60, 70]], box_labels=[1])
        outs.append(list(p.propagate_in_video(sid)))
    want, got = outs
    assert [o["frame_index"] for o in got] == [o["frame_index"]
                                               for o in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert set(g["outputs"]) == set(w["outputs"])
        for k, a in w["outputs"].items():
            if a.dtype.kind == "f":
                close_scaled(g["outputs"][k], a, 1e-4)
            else:
                np.testing.assert_array_equal(g["outputs"][k], a, err_msg=k)
