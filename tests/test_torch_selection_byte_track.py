"""skix_torch selection, hole filling and ByteTrack against skix's, on the
same seeded detection streams (CPU): the same picks, the same ids."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.perception import byte_track as jbt
from skix.perception import selection as jsel
from skix_torch.perception import byte_track as tbt
from skix_torch.perception import selection as tsel

import torch

T, N = 24, 6


def _stream(seed, T=T, N=N):
    """A few moving people (one crossing another, one leaving, one arriving
    late), slots shuffled per frame, scores spread over the three bands,
    frames and slots dropped, plus clutter."""
    rng = np.random.default_rng(seed)
    people = [(0, T, 60, 50, 2.5, 0.5, 30, 70, 0.9),
              (0, T - 6, 150, 60, -2.0, 0.2, 28, 66, 0.6),
              (5, T, 20, 120, 1.0, -1.0, 26, 60, 0.2),
              (10, T, 200, 30, -1.5, 1.5, 32, 72, 0.35)]
    boxes = np.zeros((T, N, 4), np.float32)
    scores = np.zeros((T, N), np.float32)
    valid = np.zeros((T, N), bool)
    for t in range(T):
        slots = rng.permutation(N)
        si = 0
        for (t0, t1, x0, y0, vx, vy, w, h, sc) in people:
            if not (t0 <= t < t1) or rng.random() < 0.1:
                continue
            n = slots[si]
            si += 1
            cx = x0 + vx * t + rng.normal()
            cy = y0 + vy * t + rng.normal()
            boxes[t, n] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            scores[t, n] = np.clip(sc + 0.05 * rng.normal(), 0.05, 1.0)
            valid[t, n] = True
        if rng.random() < 0.3 and si < N:      # clutter
            n = slots[si]
            c = rng.uniform(0, 240, 2)
            boxes[t, n] = [c[0], c[1], c[0] + 10, c[1] + 12]
            scores[t, n] = rng.uniform(0.1, 0.5)
            valid[t, n] = True
    return boxes, scores, valid


def _cxcywh(xyxy):
    return np.stack([(xyxy[..., 0] + xyxy[..., 2]) / 2,
                     (xyxy[..., 1] + xyxy[..., 3]) / 2,
                     xyxy[..., 2] - xyxy[..., 0],
                     xyxy[..., 3] - xyxy[..., 1]], -1).astype(np.float32)


def _flow_motion(seed, H=64, W=96):
    """A pan-and-zoom optical flow (T-1, 2, H, W) and its affine fits."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    flows = []
    for _ in range(T - 1):
        a = 1.0 + 0.01 * rng.normal()
        b = rng.normal(size=2) * 2.0
        flows.append(np.stack([(a - 1) * xs + b[0], (a - 1) * ys + b[1]]))
    return np.asarray(flows, np.float32)


@jax.jit
def _skix_select_fill(cx, kpts, valid, tids):
    sel = jsel.select_person_sequence(cx, kpts, det_valid=valid,
                                      track_ids=tids)
    return sel, [jsel.fill_invalid_frames(getattr(sel, name), sel.valid)
                 for name in ("keypoints", "scores", "boxes")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection_and_fill_match_skix(seed):
    boxes, scores, valid = _stream(seed)
    rng = np.random.default_rng(seed + 10)
    kpts = rng.normal(size=(T, N, 17, 3)).astype(np.float32)
    tids = np.where(valid, rng.integers(-1, 3, (T, N)), -1).astype(np.int32)
    valid[[3, 4, T - 1]] = False            # holes, one at the tail
    cx = _cxcywh(boxes)
    want, filled = _skix_select_fill(cx, kpts, valid, tids)
    got = tsel.select_person_sequence(torch.tensor(cx), torch.tensor(kpts),
                                      det_valid=torch.tensor(valid),
                                      track_ids=torch.tensor(tids))
    np.testing.assert_array_equal(got.sel_idx.numpy(),
                                  np.asarray(want.sel_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name, w in zip(("keypoints", "scores", "boxes"), filled):
        g = tsel.fill_invalid_frames(getattr(got, name), got.valid)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fill_with_no_valid_frame_is_zero_like_skix():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    v = np.zeros(4, bool)
    np.testing.assert_array_equal(
        tsel.fill_invalid_frames(torch.tensor(x), torch.tensor(v)).numpy(),
        np.asarray(jsel.fill_invalid_frames(x, v)))


_JIT = {}


def _skix_ids(boxes, scores, valid, cfg, motion=None):
    key = (cfg, motion is not None)
    if key not in _JIT:
        _JIT[key] = jit0(lambda b, s, v, m=None: jbt.track_sequence_ids(
            b, s, v, cfg, motion=m))
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    return np.asarray(_JIT[key](*args) if motion is None
                      else _JIT[key](*args, jnp.asarray(motion)))


@pytest.mark.parametrize("mode", ["bytetrack", "botsort"])
@pytest.mark.parametrize("seed", [0, 3])
def test_track_ids_match_skix(mode, seed):
    boxes, scores, valid = _stream(seed)
    cfg_j = jbt.ByteTrackConfig(max_tracks=8)
    cfg_t = tbt.ByteTrackConfig(max_tracks=8)
    motion_j = motion_t = None
    if mode == "botsort":
        flow = _flow_motion(seed)
        gy, gx = jbt.motion_grid(*flow.shape[-2:])
        pts = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        samples = flow[:, :, gy, gx].reshape(T - 1, 2, -1).transpose(0, 2, 1)
        motion_j = np.asarray(jbt.fit_global_motion(pts, samples))
        motion_t = tbt.fit_global_motion(torch.tensor(pts),
                                         torch.tensor(samples.copy()))
        np.testing.assert_allclose(motion_t.numpy(), motion_j, atol=1e-4)
        np.testing.assert_array_equal(tbt.motion_grid(64, 96)[0], gy)
    want = _skix_ids(boxes, scores, valid, cfg_j, motion_j)
    got = tbt.track_sequence_ids(torch.tensor(boxes), torch.tensor(scores),
                                 torch.tensor(valid), cfg_t,
                                 motion=motion_t).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > T           # the tracker emitted ids


def test_kalman_and_gmc_steps_match_skix():
    rng = np.random.default_rng(5)
    z = np.abs(rng.normal(size=(4, 4)).astype(np.float32)) * [50, 40, 1, 60]
    z = (z + [10, 10, 0.2, 10]).astype(np.float32)
    z2 = (z + rng.normal(size=z.shape).astype(np.float32)).astype(np.float32)
    warp = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0]], np.float32)

    @jax.jit
    def skix_steps(z, z2, warp):
        m0, c0 = jax.vmap(jbt._kalman_initiate)(z)
        m1, c1 = jax.vmap(jbt._kalman_predict)(m0, c0)
        m2, c2 = jax.vmap(jbt._kalman_update)(m1, c1, z2)
        return c0, m1, c1, m2, c2, jbt._apply_gmc(m2, c2, warp)

    _, jm, jc, jm2, jc2, jg = skix_steps(z, z2, warp)
    tm, tc = tbt._kalman_initiate(torch.tensor(z))
    tm, tc = tbt._kalman_predict(tm, tc)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    tm2, tc2 = tbt._kalman_update(tm, tc, torch.tensor(z2))
    np.testing.assert_allclose(tm2.numpy(), np.asarray(jm2), rtol=1e-5)
    np.testing.assert_allclose(tc2.numpy(), np.asarray(jc2), rtol=1e-4,
                               atol=1e-5)
    tg = tbt._apply_gmc(tm2, tc2, torch.tensor(warp))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_exact_match_raises_naming_the_training_slice():
    """``exact_match: true`` (the auction with the ``1 − thresh`` gate in
    every association stage) runs and gives skix's ids on a 32-frame
    stream. The name is the one this test had while the port refused the
    option."""
    boxes, scores, valid = _stream(0, T=32)
    cfg_j = jbt.ByteTrackConfig(max_tracks=8, exact_match=True)
    cfg_t = tbt.ByteTrackConfig(max_tracks=8, exact_match=True)
    want = _skix_ids(boxes, scores, valid, cfg_j)
    got = tbt.track_sequence_ids(torch.tensor(boxes), torch.tensor(scores),
                                 torch.tensor(valid), cfg_t).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 32          # the tracker emitted ids
