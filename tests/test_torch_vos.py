"""skix_torch's mask-prompted video object segmentation against skix on
the CPU, on the committed trained 112 px tracker
(``tests/fixtures/tracker_tiny.npz``: 48 features over 2 heads, head dim
24) and the fixture script's synthetic clips: ``propagate_object``,
``propagate_objects`` and ``InteractiveVideoPredictor`` (``add_new_mask``,
forward and reverse propagation, the conditioning-frame choice, the
clearing calls and the errors). Also the attention entries at head dims
the kernels do not instantiate (8, 24, 48), which pad to the next kernel
width, through the plain path.

Tolerances: mask logits to 1e-4 of their scale (the trained tracker's
logits reach ~30; float32 sums in two libraries' orders); masks on at
least 99.9 % of pixels; the chosen conditioning frames, object ids and
errors equal. Attention: 1e-5 against the plain version at the true head
dim (zero columns change no product).

skix's drivers call ``model.apply`` eagerly and jit ``apply_model`` at
XLA's default level; the file hands them the tracker behind a proxy whose
top-level applies compile at level 0 (``_torch_parity._CHEAP``), and
``apply_model`` likewise.
"""

import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import _CHEAP, close_scaled

FIXTURE = Path(__file__).parent / "fixtures" / "tracker_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))


class _CheapApply:
    """skix's flax module with each top-level ``apply`` compiled once at
    XLA's level 0 (Python bools static); inside an outer jit it applies
    as it is."""

    def __init__(self, module):
        self._m, self._jit = module, {}

    def __getattr__(self, name):
        return getattr(self._m, name)

    def apply(self, variables, *args, method=None):
        static = tuple(i + 1 for i, a in enumerate(args)
                       if isinstance(a, bool))
        key = (method.__name__, static)
        if key not in self._jit:
            self._jit[key] = jax.jit(functools.partial(
                self._m.apply, method=getattr(self._m, method.__name__)),
                static_argnums=static, compiler_options=_CHEAP)
        try:
            return self._jit[key](variables, *args)
        except ValueError as e:          # traced by an outer jit
            if "top-level" not in str(e):
                raise
            return self._m.apply(variables, *args, method=method)


@pytest.fixture(scope="module")
def world():
    import make_tracker_fixture as mtf

    return mtf


@pytest.fixture(scope="module")
def trackers(world):
    """(skix tracker proxy, its variables, the port's tracker), with
    skix's ``apply_model`` compiled at level 0 for the file."""
    import skix.tracking.vos_predictor as VP
    import skix.utils.jitapply as JA
    from skix.tracking.memory_tracker import MaskMemoryTracker
    from skix_torch.tracking.fixture import TRACKER, load_tracker_fixture

    mp = pytest.MonkeyPatch()
    cheap = jax.jit(JA.apply_model.__wrapped__, static_argnums=(0, 1),
                    compiler_options=_CHEAP)
    mp.setattr(JA, "apply_model", cheap)
    mp.setattr(VP, "apply_model", cheap)
    _, trk_vars = world.load_fixture(FIXTURE)
    _, port = load_tracker_fixture(FIXTURE, device="cpu")
    yield _CheapApply(MaskMemoryTracker(**TRACKER)), trk_vars, port
    mp.undo()


@pytest.fixture(scope="module")
def clip(world):
    """The fixture script's eval clip (``eval_tracker``: 2 objects, 6
    frames)."""
    frames, _, masks, _ = world.synth_clip(20_000, T=6, n_obj=2,
                                           min_sep=1.5)
    return frames, masks


def _masks_agree(got, want):
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.999


# --------------------------------------------------------------------------
# attention at head dims the kernels do not instantiate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("D", [8, 24, 48])
def test_attention_pads_head_dim_on_plain_path(D):
    """Padded q, k, v give the true-D plain result, with the default
    scale of the true D; gradients slice back; the lse entry too."""
    from skix_torch.ops import attention as A

    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn((2, 2, 40, D), generator=g) for _ in range(3))
    assert A._padded_head_dim(D, None) == {8: 32, 24: 32, 48: 64}[D]
    want = A.attention_reference(q, k, v, 1.0 / D ** 0.5)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    got = A.flash_attention(qg, kg, vg)
    assert got.shape == q.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    do = torch.randn(got.shape, generator=g)
    got.backward(do)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = torch.softmax(qr @ kr.transpose(-1, -2) / D ** 0.5, -1) @ vr
    ref.backward(do)
    for a, b in ((qg, qr), (kg, kr), (vg, vr)):
        assert a.grad.shape == b.grad.shape
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)
    o, lse = A.flash_attention_with_lse(q, k, v, 0.3)
    want_o, want_lse = A.attention_reference(q, k, v, 0.3, return_lse=True)
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    # rope at such a D runs on the plain path unpadded (the card refuses)
    assert A._padded_head_dim(D, torch.ones(1)) == D


def test_memory_attention_at_head_dim_24_matches_skix():
    """skix's ``flash_attention_with_lse`` at the fixture tracker's shape
    (head dim 24, a q shared by the banks) against the port's, padded."""
    from skix.ops.attention import flash_attention_with_lse as skix_lse
    from skix_torch.ops.attention import flash_attention_with_lse

    r = np.random.default_rng(0)
    q = r.normal(size=(1, 2, 196, 24)).astype(np.float32) * 0.2
    k, v = (r.normal(size=(3, 2, 588, 24)).astype(np.float32)
            for _ in range(2))
    want_o, want_l = skix_lse(jnp.broadcast_to(q, (3, 2, 196, 24)), k, v,
                              sm_scale=1.0)
    got_o, got_l = flash_attention_with_lse(
        torch.as_tensor(q).expand(3, -1, -1, -1), torch.as_tensor(k),
        torch.as_tensor(v), sm_scale=1.0)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5,
                               rtol=0)


# --------------------------------------------------------------------------
# propagate_object(s) on the trained tracker
# --------------------------------------------------------------------------
def test_propagate_object_matches_skix(trackers, clip, world):
    from skix.tracking.memory_tracker import propagate_object as skix_prop
    from skix_torch.tracking.memory_tracker import propagate_object

    skix_trk, trk_vars, port = trackers
    frames, masks = clip
    for k in (0, 1):
        want_l, want_s = skix_prop(skix_trk, trk_vars, frames, masks[0, k])
        got_l, got_s = propagate_object(port, frames, masks[0, k])
        assert got_l.shape == (6, 14, 14) and got_s.shape == (6,)
        close_scaled(got_l, want_l, 1e-4)
        close_scaled(got_s, want_s, 1e-4)
        _masks_agree(got_l > 0, np.asarray(want_l) > 0)
    # uint8 frames take the /255 rule
    got_u8, _ = propagate_object(port, (frames * 255).astype(np.uint8),
                                 masks[0, 1])
    assert np.isfinite(got_u8).all()


def test_propagate_objects_matches_skix(trackers, clip):
    """N banks in one batch; skix ``vmap``s them and jits its step at the
    default level (patched to level 0 here)."""
    from skix.tracking.memory_tracker import propagate_objects as skix_props
    from skix_torch.tracking.memory_tracker import propagate_objects

    skix_trk, trk_vars, port = trackers
    frames, masks = clip
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", functools.partial(jax.jit,
                                             compiler_options=_CHEAP))
    try:
        want_l, want_s = skix_props(skix_trk, trk_vars, frames, masks[0, :2])
    finally:
        mp.undo()
    got_l, got_s = propagate_objects(port, frames, masks[0, :2])
    assert got_l.shape == (6, 2, 14, 14) and got_s.shape == (6, 2)
    close_scaled(got_l, want_l, 1e-4)
    close_scaled(got_s, want_s, 1e-4)
    _masks_agree(got_l > 0, np.asarray(want_l) > 0)


# --------------------------------------------------------------------------
# the interactive predictor
# --------------------------------------------------------------------------
def _run(pred, state, **kw):
    return list(pred.propagate_in_video(state, **kw))


def _same_outputs(got, want):
    assert [o["frame_index"] for o in got] == [o["frame_index"] for o in want]
    for g, w in zip(got, want):
        assert g["obj_ids"] == w["obj_ids"]
        close_scaled(g["logits"], w["logits"], 1e-4)
        _masks_agree(g["masks"], w["masks"])


def test_predictor_matches_skix(trackers, world):
    """add_new_mask on frame 0 for two objects, forward; a second mask on
    frame 6, then reverse from the end; a third conditioning frame with
    ``max_cond_slots=2`` (the nearest-frames rule); clearing a frame."""
    from skix.tracking.vos_predictor import \
        InteractiveVideoPredictor as SkixPredictor
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor

    skix_trk, trk_vars, port = trackers
    frames, _, masks, _ = world.synth_clip(20_001, T=10, n_obj=2,
                                           min_sep=1.5)
    u8 = (frames * 255).astype(np.uint8)
    sp = SkixPredictor(skix_trk, trk_vars, max_cond_slots=2)
    pp = InteractiveVideoPredictor(port, max_cond_slots=2)
    ss, ps = sp.init_state(u8), pp.init_state(u8)
    assert ps["grid_hw"] == (14, 14)
    for obj in (1, 2):
        want = sp.add_new_mask(ss, 0, obj, masks[0, obj - 1])
        got = pp.add_new_mask(ps, 0, obj, masks[0, obj - 1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_outputs(_run(pp, ps), _run(sp, ss))
    assert ps["last_cond_selected"] == ss["last_cond_selected"]

    sp.add_new_mask(ss, 6, 1, masks[6, 0])
    pp.add_new_mask(ps, 6, 1, masks[6, 0])
    _same_outputs(_run(pp, ps, reverse=True, max_frame_num_to_track=6),
                  _run(sp, ss, reverse=True, max_frame_num_to_track=6))
    sp.add_new_mask(ss, 9, 1, masks[9, 0])
    pp.add_new_mask(ps, 9, 1, masks[9, 0])
    got = _run(pp, ps, start_frame_idx=2, max_frame_num_to_track=2)
    want = _run(sp, ss, start_frame_idx=2, max_frame_num_to_track=2)
    _same_outputs(got, want)
    assert ps["last_cond_selected"] == ss["last_cond_selected"]
    pp._bank_for(ps, ps["objects"][1], 2, [])
    sp._bank_for(ss, ss["objects"][1], 2, [])
    assert ps["last_cond_selected"] == ss["last_cond_selected"] == [0, 6]

    for p, s in ((pp, ps), (sp, ss)):
        p.clear_all_points_in_frame(s, 6, 1)
        p.clear_all_points_in_video(s)
        p.remove_object(s, 2)
        p.remove_object(s, 7)
    assert sorted(ps["objects"][1]["cond"]) == sorted(ss["objects"][1]["cond"])
    assert list(ps["objects"]) == list(ss["objects"]) == [1]
    _same_outputs(_run(pp, ps), _run(sp, ss))


def test_predictor_errors_match_skix(trackers):
    from skix.tracking.vos_predictor import \
        InteractiveVideoPredictor as SkixPredictor
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor

    skix_trk, trk_vars, port = trackers
    frames = np.zeros((3, 112, 112, 3), np.uint8)
    for make in (lambda: SkixPredictor(skix_trk, trk_vars,
                                       max_cond_frames=1),
                 lambda: InteractiveVideoPredictor(port, max_cond_frames=1)):
        with pytest.raises(ValueError, match="max_cond_frames must be >= 2"):
            make()
    sp = SkixPredictor(skix_trk, trk_vars)
    pp = InteractiveVideoPredictor(port)
    for p in (sp, pp):
        s = p.init_state(frames)
        with pytest.raises(RuntimeError, match="no prompted objects"):
            next(p.propagate_in_video(s))
        with pytest.raises(RuntimeError, match="InteractiveSegmenter"):
            p.add_new_points_or_box(s, 0, 1, points=[[3, 4]], labels=[1])
        with pytest.raises(KeyError):
            p.remove_object(s, 5, strict=True)
    # with a segmenter, skix's prompt checks come before any decode
    seg = types.SimpleNamespace(img_size=64)
    sp = SkixPredictor(skix_trk, trk_vars, segmenter=seg)
    pp = InteractiveVideoPredictor(port, segmenter=seg)
    for p in (sp, pp):
        s = p.init_state(frames)
        with pytest.raises(ValueError, match="together"):
            p.add_new_points_or_box(s, 0, 1, points=[[3, 4]])
        with pytest.raises(ValueError, match="at least one"):
            p.add_new_points_or_box(s, 0, 1)
        with pytest.raises(ValueError, match="clearing old points"):
            p.add_new_points_or_box(s, 0, 1, box=[1, 1, 9, 9],
                                    clear_old_points=False)
