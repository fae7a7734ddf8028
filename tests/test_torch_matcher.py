"""skix_torch.tracking.matcher against skix.tracking.matcher.

Both packages take the same fixed ``Sam3Detections``-shaped arrays (boxes,
logits, masks, per-layer aux and DAC o2m outputs), made from a numpy seed:
the greedy assignments, with and without ``repeats``, are the same pairs;
the loss values agree to 1e-5 relative, and the gradients of the losses
with respect to the predictions to 1e-5 of their largest element. So do
the exact (auction) matching's losses and the PointRend sampled mask loss,
whose candidate points are the same numbers on both sides: skix's
``jax.random.uniform`` and the port's ``matcher.uniform_points`` are
patched to draws that depend on the shape only (:func:`_same_points`).
"""

import contextlib


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.tracking import matcher as SM
from skix.tracking.sam3_detector import Sam3Detections as SkixDetections
from skix_torch.tracking import matcher as TM
from skix_torch.tracking.sam3_detector import Sam3Detections

B, Q, G, L, HM = 3, 10, 4, 3, 12


def _detections(seed):
    """Predictions (numpy) in Sam3Detections' fields, and ground truth."""
    r = np.random.default_rng(seed)

    def boxes(*lead):
        cxcy = r.uniform(0.2, 0.8, (*lead, 2))
        wh = r.uniform(0.05, 0.4, (*lead, 2))
        return np.concatenate([cxcy, wh], -1).astype(np.float32)

    def logits(*lead):
        return r.normal(0, 2, lead).astype(np.float32)

    pred = {
        "boxes_cxcywh": boxes(B, Q), "scores": logits(B, Q),
        "mask_logits": logits(B, Q, HM, HM), "embeddings":
        np.zeros((B, Q, 8), np.float32), "presence": logits(B),
        "aux_boxes": tuple(boxes(B, Q) for _ in range(L - 1)) + (None,),
        "o2m_boxes": boxes(B, Q), "o2m_scores": logits(B, Q),
        "o2m_mask_logits": logits(B, Q, HM, HM),
        "o2m_aux_boxes": tuple(boxes(B, Q) for _ in range(L - 1)) + (None,),
        "aux_scores": tuple(logits(B, Q) for _ in range(L - 1)),
        "o2m_aux_scores": tuple(logits(B, Q) for _ in range(L - 1)),
    }
    # the last aux layer is the final one, as the decoder returns it
    pred["aux_boxes"] = pred["aux_boxes"][:-1] + (pred["boxes_cxcywh"],)
    pred["o2m_aux_boxes"] = pred["o2m_aux_boxes"][:-1] + (pred["o2m_boxes"],)
    gt = boxes(B, G)
    valid = np.array([[True, True, False, True], [True, False, False, False],
                      [False, False, False, False]])
    gt[~valid] = 0.0
    masks = r.random((B, G, 9, 9)) > 0.5     # resized (nearest) to 12 × 12
    return pred, gt, valid, masks


def _skix(pred):
    return SkixDetections(**jax.tree.map(jnp.asarray, pred))


def _port(pred, grad=False):
    t = {k: (tuple(torch.tensor(x, requires_grad=grad) for x in v)
             if isinstance(v, tuple) else torch.tensor(v, requires_grad=grad))
         for k, v in pred.items()}
    return Sam3Detections(**t)


@pytest.mark.parametrize("repeats", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_assign_matches_skix(seed, repeats):
    pred, gt, valid, _ = _detections(seed)
    cost, want = jit0(lambda b, s, g, v: (lambda c: (c, jax.vmap(
        lambda c1, v1: SM.greedy_assign(c1, v1, repeats=repeats))(c, v)))(
        jax.vmap(SM.matching_cost)(b, jax.nn.sigmoid(s), g)))(
        pred["boxes_cxcywh"], pred["scores"], gt, valid)
    got_cost = TM.matching_cost(torch.as_tensor(pred["boxes_cxcywh"]),
                                torch.sigmoid(torch.as_tensor(pred["scores"])),
                                torch.as_tensor(gt))
    np.testing.assert_allclose(got_cost.numpy(), np.asarray(cost), atol=1e-6,
                               rtol=1e-6)
    got = TM.greedy_assign(got_cost, torch.as_tensor(valid), repeats=repeats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one-to-many: each valid gt takes up to `repeats` queries
    counts = [(got[b] == g).sum().item() for b in range(B) for g in range(G)]
    assert max(counts) == (repeats if repeats > 1 else 1)


def _rel(a, b, tol=1e-5):
    a, b = float(torch.as_tensor(a).detach()), float(b)
    assert abs(a - b) <= tol * max(abs(b), 1e-6), (a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_iabce_and_presence_match_skix(seed):
    pred, gt, valid, _ = _detections(seed)
    lg, bx = pred["scores"], pred["boxes_cxcywh"]
    assign = np.array([np.arange(Q) % G - (np.arange(Q) >= G) * 9
                       for _ in range(B)]).clip(-1)
    assign = np.where(valid[np.arange(B)[:, None], assign.clip(0)], assign, -1)
    keep = valid.any(-1)
    want = jit0(jax.vmap(lambda l, b, g, a, k: SM.iabce_classification_loss(
        l, b, g, a, keep=k)))(*map(jnp.asarray, (lg, bx, gt, assign, keep)))
    got = TM.iabce_classification_loss(*map(torch.as_tensor,
                                            (lg, bx, gt, assign)),
                                       keep=torch.as_tensor(keep))
    for g_, w_ in zip(got, np.asarray(want)):
        _rel(g_, w_)
    want_p, want_k = jit0(jax.vmap(SM.presence_loss))(
        jnp.asarray(pred["presence"]), jnp.asarray(gt), jnp.asarray(valid))
    got_p, got_k = TM.presence_loss(torch.as_tensor(pred["presence"]),
                                    torch.as_tensor(gt),
                                    torch.as_tensor(valid))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    for g_, w_ in zip(got_p, np.asarray(want_p)):
        _rel(g_, w_)


@pytest.mark.parametrize("seed,cls", [(0, "iabce"), (1, "focal")])
def test_sam3_detection_loss_matches_skix(seed, cls):
    """o2o + aux layers with their own logits + presence + DAC o2m, as
    train_detector calls it; gradients with respect to every prediction."""
    pred, gt, valid, _ = _detections(seed)
    kw = dict(cls=cls, w_class=20.0 if cls == "iabce" else 1.0,
              w_presence=20.0 if cls == "iabce" else 0.0)

    def skix_loss(p):
        return SM.sam3_detection_loss(_skix(p), jnp.asarray(gt),
                                      jnp.asarray(valid), **kw)

    want, want_g = jit0(jax.value_and_grad(skix_loss))(pred)
    det = _port(pred, grad=True)
    got = TM.sam3_detection_loss(det, torch.as_tensor(gt),
                                 torch.as_tensor(valid), **kw)
    _rel(got, want)
    got.backward()
    for name in ("boxes_cxcywh", "scores", "presence", "o2m_boxes",
                 "o2m_scores"):
        g, w = getattr(det, name).grad, np.asarray(want_g[name])
        if g is None:        # not in the loss (presence with the focal cls)
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(),
                                   rtol=0, err_msg=name)
    for i in range(L - 1):
        w = np.asarray(want_g["aux_scores"][i])
        np.testing.assert_allclose(det.aux_scores[i].grad.numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_sam3_mask_loss_matches_skix(seed):
    """Full-grid CE + dice on the matched queries, the ground-truth masks
    resized (nearest) to the logits' grid."""
    pred, gt, valid, masks = _detections(seed)

    def skix_loss(p):
        return SM.sam3_mask_loss(_skix(p), jnp.asarray(gt),
                                 jnp.asarray(masks), jnp.asarray(valid))

    want, want_g = jit0(jax.value_and_grad(skix_loss))(pred)
    det = _port(pred, grad=True)
    got = TM.sam3_mask_loss(det, torch.as_tensor(gt), torch.as_tensor(masks),
                            torch.as_tensor(valid))
    _rel(got, want)
    got.backward()
    w = np.asarray(want_g["mask_logits"])
    np.testing.assert_allclose(det.mask_logits.grad.numpy(), w,
                               atol=1e-5 * np.abs(w).max(), rtol=0)


def test_unported_matching_raises():
    """The exact (auction) matching in the detection loss, o2o with the aux
    layers and o2m with three repeats, as train_detector calls it with
    ``loss.exact_match``: skix's loss and gradients. The name is the one
    this test had while the port refused the option."""
    pred, gt, valid, _ = _detections(0)
    kw = dict(cls="iabce", w_class=20.0, w_presence=20.0, exact=True)

    def skix_loss(p):
        return SM.sam3_detection_loss(_skix(p), jnp.asarray(gt),
                                      jnp.asarray(valid), **kw)

    want, want_g = jit0(jax.value_and_grad(skix_loss))(pred)
    det = _port(pred, grad=True)
    got = TM.sam3_detection_loss(det, torch.as_tensor(gt),
                                 torch.as_tensor(valid), **kw)
    _rel(got, want)
    got.backward()
    for name in ("boxes_cxcywh", "scores", "o2m_boxes", "o2m_scores"):
        g, w = getattr(det, name).grad, np.asarray(want_g[name])
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(),
                                   rtol=0, err_msg=name)


def _draws(shape):
    """Uniform numbers that depend on the last three axes of ``shape`` only
    (skix draws per image under ``vmap``: every image gets the same)."""
    seed = int(np.prod(shape[-3:]))
    return np.random.default_rng(seed).random(shape[-3:]).astype(np.float32)


@contextlib.contextmanager
def _same_points():
    """skix's ``jax.random.uniform`` and the port's ``uniform_points`` give
    :func:`_draws`' numbers."""
    orig_j, orig_t = jax.random.uniform, TM.uniform_points

    def fake_j(key, shape=(), *a, **k):
        return jnp.asarray(_draws(shape))

    def fake_t(generator, shape, device):
        return torch.as_tensor(_draws(shape)).expand(shape).to(device)

    jax.random.uniform, TM.uniform_points = fake_j, fake_t
    try:
        yield
    finally:
        jax.random.uniform, TM.uniform_points = orig_j, orig_t


def test_point_sample_matches_skix():
    """Bilinear taps with zeros outside, points inside and outside [0, 1]²."""
    r = np.random.default_rng(4)
    masks = r.normal(size=(3, 5, 9, 7)).astype(np.float32)
    coords = r.uniform(-0.1, 1.1, (3, 5, 40, 2)).astype(np.float32)
    want = np.asarray(jit0(SM.point_sample)(masks, coords))
    got = TM.point_sample(torch.tensor(masks), torch.tensor(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_uncertain_point_coords_matches_skix():
    """The same candidates: the same importance picks (a stable sort on
    −|logit|) and the same fresh points."""
    r = np.random.default_rng(5)
    logits = r.normal(0, 2, (Q, HM, HM)).astype(np.float32)
    with _same_points():
        want = np.asarray(jit0(lambda m, k: SM.uncertain_point_coords(
            m, k, 20))(logits, jax.random.PRNGKey(0)))
        got = TM.uncertain_point_coords(torch.tensor(logits),
                                        torch.Generator(), 20).numpy()
    assert got.shape == (Q, 20, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact", [False, True])
def test_sampled_mask_loss_matches_skix(exact):
    """PointRend's focal + dice on 24 points a mask, the ground truth
    sampled at its 9 × 9 resolution; loss and gradients within 1e-5 of
    their scale."""
    pred, gt, valid, masks = _detections(1)

    def skix_loss(p):
        return SM.sam3_mask_loss(_skix(p), jnp.asarray(gt),
                                 jnp.asarray(masks), jnp.asarray(valid),
                                 exact=exact, num_sample_points=24,
                                 rng=jax.random.PRNGKey(0))

    with _same_points():
        want, want_g = jit0(jax.value_and_grad(skix_loss))(pred)
        det = _port(pred, grad=True)
        got = TM.sam3_mask_loss(det, torch.as_tensor(gt),
                                torch.as_tensor(masks),
                                torch.as_tensor(valid), exact=exact,
                                num_sample_points=24,
                                generator=torch.Generator())
    _rel(got, want)
    got.backward()
    w = np.asarray(want_g["mask_logits"])
    np.testing.assert_allclose(det.mask_logits.grad.numpy(), w,
                               atol=1e-5 * np.abs(w).max(), rtol=0)
    with pytest.raises(ValueError, match="generator"):
        TM.sam3_mask_loss(det, torch.as_tensor(gt), torch.as_tensor(masks),
                          torch.as_tensor(valid), num_sample_points=24)
