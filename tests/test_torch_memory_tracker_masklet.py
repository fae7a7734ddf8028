"""skix_torch's memory tracker, masklet lifecycle, mask/box ops and resize
against skix on the CPU, at tiny widths, from the same numpy inputs.

Tolerances: float32 model outputs to 1e-4 (the port's dense memory
attention runs the plain K1 with its base-2 lse, skix its XLA reference
with a natural-log lse); the lifecycle's integer and bool state exactly;
resize to 1e-5 (the same weights, products summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import jit0, random_variables

from skix_torch.convert import flax_to_state_dict, load_into

FEATURES, HEADS, SLOTS = 32, 2, 4


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# --------------------------------------------------------------------------
# memory tracker
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trackers():
    from skix.tracking.memory_tracker import MaskMemoryTracker as SkixTrk
    from skix.tracking.memory_tracker import init_memory as skix_init_memory
    from skix_torch.tracking.memory_tracker import MaskMemoryTracker

    r = np.random.default_rng(11)
    img = r.random((1, 32, 32, 3)).astype(np.float32)
    m = SkixTrk(features=FEATURES, num_heads=HEADS, mem_slots=SLOTS)
    v = random_variables(m, r, jnp.asarray(img),
                         skix_init_memory(SLOTS, 4, 4, FEATURES),
                         method=m.step)
    port = MaskMemoryTracker(features=FEATURES, num_heads=HEADS,
                             mem_slots=SLOTS)
    load_into(port, flax_to_state_dict(v))
    return m, v, port.eval(), img


def _banks(r, gh, gw):
    """Three object banks: two valid slots, one, none (empty bank)."""
    mem = r.normal(size=(3, SLOTS, gh, gw, FEATURES)).astype(np.float32)
    valid = np.array([[True, False, True, False],
                      [True, False, False, False],
                      [False] * SLOTS])
    mem[~valid] = 0.0          # invalid slots hold zero memory
    ring = np.array([3, 1, 1])
    return mem, valid, ring


@pytest.fixture(scope="module")
def feats(trackers):
    """skix's encode_frame of the image, jitted once for the file."""
    m, v, _, img = trackers
    return jit0(lambda v, x: m.apply(v, x, method=m.encode_frame))(
        v, jnp.asarray(img))


def test_encode_frame_matches_skix(trackers, feats):
    """Stride-8 conv trunk: stride-2 SAME convs pad (0, 1) on even sizes."""
    m, v, port, img = trackers
    want = feats
    with torch.no_grad():
        got = port.encode_frame(torch.as_tensor(img))
    assert got.shape == (1, 4, 4, FEATURES)
    _close(got, want)


@pytest.mark.parametrize("dense", [True, False])
def test_attend_decode_matches_skix(trackers, feats, dense):
    """Dense (K1 with lse + the invalid-slot correction) and the slot scan,
    over banks with two, one and no valid slots; skix runs one bank per
    call, the port all three as a batch."""
    from skix.tracking.memory_tracker import MemoryBank as SkixBank
    from skix_torch.tracking.memory_tracker import MemoryBank

    m, v, port, img = trackers
    r = np.random.default_rng(12)
    mem, valid, ring = _banks(r, 4, 4)
    attend = jit0(lambda v, f, bank: m.apply(v, f, bank, dense,
                                                method=m.attend_decode))
    want = [attend(v, feats, SkixBank(jnp.asarray(mem[i]),
                                      jnp.asarray(valid[i]),
                                      jnp.asarray(ring[i]))) for i in range(3)]
    with torch.no_grad():
        masks, scores = port.attend_decode(
            torch.as_tensor(np.array(feats)),
            MemoryBank(torch.as_tensor(mem), torch.as_tensor(valid),
                       torch.as_tensor(ring)), dense=dense)
    for i in range(3):
        _close(masks[i], want[i][0][0])
        _close(scores[i], want[i][1][0])


def test_encode_memory_matches_skix(trackers, feats):
    m, v, port, img = trackers
    r = np.random.default_rng(13)
    logits = (r.normal(size=(3, 4, 4)) * 4).astype(np.float32)
    want = jit0(jax.vmap(lambda lg: m.apply(v, feats[0], lg,
                                               method=m.encode_memory)))(
        jnp.asarray(logits))
    with torch.no_grad():
        got = port.encode_memory(torch.as_tensor(np.array(feats)),
                                 torch.as_tensor(logits))
    _close(got, want)


def test_step_from_feats_matches_skix(trackers, feats):
    """Attention + decode + a memory write into each object's ring."""
    from skix.tracking.memory_tracker import MemoryBank as SkixBank
    from skix_torch.tracking.memory_tracker import MemoryBank

    m, v, port, img = trackers
    mem, valid, ring = _banks(np.random.default_rng(15), 4, 4)
    step = jit0(lambda v, f, bank: m.apply(v, f, bank, True, True,
                                              method=m.step_from_feats))
    with torch.no_grad():
        _, _, bank = port.step_from_feats(
            torch.as_tensor(np.array(feats)),
            MemoryBank(torch.as_tensor(mem), torch.as_tensor(valid),
                       torch.as_tensor(ring)), dense=True)
    for i in range(3):
        _, _, want = step(v, feats, SkixBank(
            jnp.asarray(mem[i]), jnp.asarray(valid[i]), jnp.asarray(ring[i])))
        _close(bank.mem[i], want.mem)
        np.testing.assert_array_equal(bank.valid[i].numpy(), want.valid)
        assert int(bank.ring_pos[i]) == int(want.ring_pos)


def test_memory_writes_match_skix():
    from skix.tracking import memory_tracker as SM
    from skix_torch.tracking import memory_tracker as TM

    r = np.random.default_rng(14)
    feat = r.normal(size=(2, 3, 3, 5)).astype(np.float32)
    bank = TM.init_memory(3, 3, 3, 5, num_objects=2)
    bank = TM.write_conditioning(bank, torch.as_tensor(feat))
    for _ in range(3):
        bank = TM.write_recent(bank, torch.as_tensor(feat) + 1)
    want = SM.write_conditioning(SM.init_memory(3, 3, 3, 5), feat[1])
    for _ in range(3):
        want = SM.write_recent(want, feat[1] + 1)
    _close(bank.mem[1], want.mem, atol=0)
    np.testing.assert_array_equal(bank.valid[1].numpy(), want.valid)
    assert int(bank.ring_pos[1]) == int(want.ring_pos)


# --------------------------------------------------------------------------
# masklet lifecycle
# --------------------------------------------------------------------------
def _frames_of_dets(seed, K=6, N=5, T=5, h=12, w=12):
    """Per frame: tracker logits of K slots and N detections, some of which
    are noisy copies of tracked masks (so IoU matches, duplicates and
    spawns all occur)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(T):
        trk = r.normal(size=(K, h, w)).astype(np.float32) * 3
        trk[r.random(K) < 0.2] = -5.0                   # some empty tracks
        det = r.normal(size=(N, h, w)).astype(np.float32) * 3
        src = r.integers(0, K, size=N)
        copy = r.random(N) < 0.6
        det[copy] = trk[src[copy]] + r.normal(size=(copy.sum(), h, w)) * 0.5
        scores = r.random(N).astype(np.float32)
        valid = r.random(N) < 0.85
        out.append((trk, det, scores, valid))
    return out


CFGS = {
    "default": {},
    "reverse": dict(reverse=True, hotstart_delay=3),
    "hotstart_occlusion": dict(hotstart_delay=2, occlusion_suppress_iou=0.2,
                               hotstart_unmatch_thresh=1,
                               hotstart_dup_thresh=1),
    "keep_alive": dict(suppress_unmatched_only_within_hotstart=False,
                       decrease_keep_alive_for_empty=True,
                       new_det_thresh=0.3),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_masklet_update_matches_skix(name):
    from skix.tracking import masklet as SML
    from skix_torch.tracking import masklet as TML

    kw = dict(max_objects=6, max_dets=5, **CFGS[name])
    scfg, tcfg = SML.MaskletConfig(**kw), TML.MaskletConfig(**kw)
    start = 10 if tcfg.reverse else 0
    s_state = SML.init_masklet_state(scfg, start)
    t_state = TML.init_masklet_state(tcfg, start)
    spawned = 0
    for trk, det, scores, valid in _frames_of_dets(21):
        s_state, s_out = SML.masklet_update(s_state, jnp.asarray(trk),
                                            jnp.asarray(det),
                                            jnp.asarray(scores),
                                            jnp.asarray(valid), scfg)
        t_state, t_out = TML.masklet_update(t_state, torch.as_tensor(trk),
                                            torch.as_tensor(det),
                                            torch.as_tensor(scores),
                                            torch.as_tensor(valid), tcfg)
        for f in TML.MaskletState._fields:
            np.testing.assert_array_equal(
                getattr(t_state, f).numpy(), np.asarray(getattr(s_state, f)),
                err_msg=f)
        for k, want in s_out.items():
            got = t_out[k].numpy()
            if got.dtype == np.float32:
                _close(got, want, atol=0)
            else:
                np.testing.assert_array_equal(got, np.asarray(want),
                                              err_msg=k)
        spawned += int(t_out["spawn"].sum())
    assert spawned > 0


def test_select_dets_matches_skix():
    """Sigmoid, box NMS, stable score-ranked top N, masks resized."""
    from skix.tracking import masklet as SML
    from skix_torch.tracking import masklet as TML

    r = np.random.default_rng(22)
    boxes = np.concatenate([r.random((9, 2)) * 0.6 + 0.2,
                            r.random((9, 2)) * 0.3 + 0.05], 1).astype(np.float32)
    logits = np.round(r.normal(size=9), 1).astype(np.float32)   # with ties
    masks = r.normal(size=(9, 16, 16)).astype(np.float32)
    kw = dict(max_dets=6, det_nms_thresh=0.3, score_threshold_detection=0.4)
    want = SML._select_dets(jnp.asarray(boxes), jnp.asarray(logits),
                            jnp.asarray(masks), SML.MaskletConfig(**kw), (7, 7))
    got = TML._select_dets(torch.as_tensor(boxes), torch.as_tensor(logits),
                           torch.as_tensor(masks), TML.MaskletConfig(**kw),
                           (7, 7))
    for g, w in zip(got, want):
        _close(g.numpy().astype(np.float32), np.asarray(w, np.float32),
               atol=1e-5)


# --------------------------------------------------------------------------
# masks, nms, resize
# --------------------------------------------------------------------------
def test_masks_to_boxes_and_mask_iou_match_skix():
    from skix.ops import masks as SM
    from skix_torch.ops import masks as TM

    r = np.random.default_rng(31)
    a = r.random((5, 9, 11)) < 0.2
    a[1] = False                                   # an empty mask
    b = r.random((4, 9, 11)) < 0.3
    np.testing.assert_array_equal(TM.masks_to_boxes(torch.as_tensor(a)).numpy(),
                                  np.asarray(SM.masks_to_boxes(a)))
    _close(TM.mask_iou(torch.as_tensor(a), torch.as_tensor(b)),
           SM.mask_iou(a, b), atol=1e-7)


@pytest.mark.parametrize("thresh", [0.1, 0.5])
def test_nms_matches_skix(thresh):
    import importlib

    from skix_torch.ops import nms as TN

    SN = importlib.import_module("skix.ops.nms")   # skix.ops re-exports nms

    r = np.random.default_rng(32)
    xy = r.random((20, 2)) * 50
    boxes = np.concatenate([xy, xy + r.random((20, 2)) * 30 + 1], 1
                           ).astype(np.float32)
    scores = np.round(r.random(20), 1).astype(np.float32)     # with ties
    _close(TN.box_iou(torch.as_tensor(boxes), torch.as_tensor(boxes)),
           SN.box_iou(boxes, boxes), atol=1e-6)
    np.testing.assert_array_equal(
        TN.nms(torch.as_tensor(boxes), torch.as_tensor(scores), thresh).numpy(),
        np.asarray(SN.nms(boxes, scores, thresh)))


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape_in,shape_out", [
    ((2, 7, 9, 3), (2, 15, 4, 3)),      # up on one axis, down on the other
    ((1, 72, 128, 3), (1, 101, 101, 3)),   # a 720x1280 frame to 1008, /10
    ((3, 14, 14), (3, 56, 56)),         # the tracker's 4x mask upsample
])
def test_resize_matches_jax_image_resize(method, shape_in, shape_out):
    from skix_torch.utils.image import resize

    x = np.random.default_rng(33).normal(size=shape_in).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), shape_out, method)
    got = resize(torch.as_tensor(x), shape_out, method)
    _close(got, want, atol=1e-5)


def test_masklet_config_defaults_match_skix():
    from skix.tracking.masklet import MaskletConfig as SkixCfg
    from skix_torch.tracking.masklet import MaskletConfig

    assert dataclasses.asdict(MaskletConfig()) == dataclasses.asdict(SkixCfg())
