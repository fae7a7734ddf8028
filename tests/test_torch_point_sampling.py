"""skix_torch's point and box samplers, multimask selection, sine embedding
and conditioning-frame selection against skix on the CPU.

Both sides take the same precomputed noise (``box_noise``, ``pts_noise``),
so the draws are shared. Tolerances: points, labels, selections and
boxes equal (float32 sums of the same operands); the sine embedding to
1e-6 (the power ``temperature ** x`` of two libraries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import jit0


@pytest.fixture(scope="module")
def S():
    """skix's samplers, each compiled once for the file (``jit0``)."""
    from types import SimpleNamespace

    from skix.tracking import point_sampling as ps

    return SimpleNamespace(
        mask_to_box=jit0(ps.mask_to_box),
        sample_box_points=jit0(ps.sample_box_points,
                               static_argnames=("noise",)),
        sample_random_points_from_errors=jit0(
            ps.sample_random_points_from_errors, static_argnames=("num_pt",)),
        sample_one_point_from_error_center=jit0(
            ps.sample_one_point_from_error_center,
            static_argnames=("padding",)),
        get_next_point=jit0(ps.get_next_point, static_argnames=("method",)),
        get_1d_sine_pe=jit0(ps.get_1d_sine_pe, static_argnames=("dim",)),
        get_best_gt_match_from_multimasks=jit0(
            ps.get_best_gt_match_from_multimasks),
        select_closest_cond_frames=jit0(
            ps.select_closest_cond_frames,
            static_argnames=("max_cond_frame_num", "keep_first_cond_frame")))


def _gt_pred(seed: int, B: int = 4, hw=(19, 23)):
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[:hw[0], :hw[1]]
    gt = np.zeros((B, 1, *hw), bool)
    pred = np.zeros_like(gt)
    for b in range(B):
        cy, cx = r.uniform(5, 14), r.uniform(5, 18)
        gt[b, 0] = (ys - cy) ** 2 + (xs - cx) ** 2 < r.uniform(9, 30)
        pred[b, 0] = (ys - cy - r.integers(-2, 3)) ** 2 + (
            xs - cx - r.integers(-2, 3)) ** 2 < r.uniform(9, 30)
    pred[1] = gt[1]                       # exactly right: a background click
    gt[2] = False                         # an empty mask
    return gt, pred


def test_mask_to_box_and_box_points_match_skix(S):
    from skix_torch.tracking import point_sampling as P

    gt, _ = _gt_pred(1)
    np.testing.assert_array_equal(P.mask_to_box(torch.as_tensor(gt)).numpy(),
                                  np.asarray(S.mask_to_box(jnp.asarray(gt))))
    noise = np.random.default_rng(2).uniform(-1, 1, (4, 1, 4)).astype(
        np.float32)
    for kw in ({"box_noise": noise}, {"noise": 0.0}):
        pts, lab = P.sample_box_points(torch.as_tensor(gt), **{
            k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
        want_p, want_l = S.sample_box_points(jnp.asarray(gt), **{
            k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
        np.testing.assert_array_equal(pts.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want_l))
    pts, _ = P.sample_box_points(torch.as_tensor(gt),
                                 torch.Generator().manual_seed(0))
    assert pts.shape == (4, 2, 2) and bool(torch.isfinite(pts).all())


@pytest.mark.parametrize("num_pt", [1, 3])
def test_random_error_points_match_skix(S, num_pt):
    from skix_torch.tracking import point_sampling as P

    gt, pred = _gt_pred(3)
    noise = np.random.default_rng(4).random((4, num_pt, 19, 23, 2)).astype(
        np.float32)
    got = P.sample_random_points_from_errors(
        torch.as_tensor(gt), torch.as_tensor(pred), num_pt=num_pt,
        pts_noise=torch.as_tensor(noise))
    want = S.sample_random_points_from_errors(
        jnp.asarray(gt), jnp.asarray(pred), num_pt=num_pt,
        pts_noise=jnp.asarray(noise))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the first occurrence on ties: all-zero noise picks pixel 0, label 0
    got0 = P.sample_random_points_from_errors(
        torch.as_tensor(gt), None, num_pt=num_pt,
        pts_noise=torch.zeros_like(torch.as_tensor(noise)))
    want0 = S.sample_random_points_from_errors(
        jnp.asarray(gt), None, num_pt=num_pt, pts_noise=jnp.zeros(noise.shape))
    for g, w in zip(got0, want0):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("padding", [True, False])
def test_error_center_point_matches_skix(S, padding):
    """The EDT click, and ``get_next_point``'s two methods."""
    from skix_torch.tracking import point_sampling as P

    gt, pred = _gt_pred(5)
    got = P.sample_one_point_from_error_center(
        torch.as_tensor(gt), torch.as_tensor(pred), padding)
    want = S.sample_one_point_from_error_center(
        jnp.asarray(gt), jnp.asarray(pred), padding=padding)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nxt = P.get_next_point(torch.as_tensor(gt), torch.as_tensor(pred),
                           "center")
    for g, w in zip(nxt, S.get_next_point(jnp.asarray(gt), jnp.asarray(pred),
                                          method="center")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pts, lab = P.get_next_point(torch.as_tensor(gt), torch.as_tensor(pred),
                                "uniform", torch.Generator().manual_seed(1))
    assert pts.shape == (4, 1, 2) and lab.shape == (4, 1)
    with pytest.raises(ValueError, match="unknown sampling method"):
        P.get_next_point(torch.as_tensor(gt), None, "nearest")


def test_sine_pe_and_multimask_match_skix(S):
    from skix_torch.tracking import point_sampling as P

    pos = np.array([[0, 3, 17], [250, 1, 9]], np.float32)
    np.testing.assert_allclose(P.get_1d_sine_pe(torch.as_tensor(pos), 32),
                               np.asarray(S.get_1d_sine_pe(pos, dim=32)),
                               rtol=0, atol=1e-6)
    r = np.random.default_rng(6)
    gt, _ = _gt_pred(7)
    multi = r.normal(size=(4, 3, 19, 23)).astype(np.float32)
    multi[0, 2] = np.where(gt[0, 0], 4.0, -4.0)   # channel 2 is exact
    scores = r.random((4, 3)).astype(np.float32)
    for m, sc in ((multi, scores), (multi, None),
                  (-np.abs(multi), scores), (multi[:, :1], None)):
        got = P.get_best_gt_match_from_multimasks(
            torch.as_tensor(m), torch.as_tensor(gt),
            None if sc is None else torch.as_tensor(sc))
        want = S.get_best_gt_match_from_multimasks(m, gt, sc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frame_idx,max_cond,keep_first", [
    (5, 3, False), (5, 2, True), (0, 2, False), (20, 4, False),
    (7, 2, True), (6, -1, False), (9, 5, False)])
def test_select_closest_cond_frames_matches_skix(S, frame_idx, max_cond,
                                                 keep_first):
    """Slots out of order, a tie in distance (3 and 7 around 5), an
    invalid slot, more candidates than room; with keep_first the forced
    picks can exceed the budget (the reference's quirk)."""
    from skix_torch.tracking import point_sampling as P

    t = np.array([7, 0, 3, 12, 9, 15, 1, 4], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    got = P.select_closest_cond_frames(frame_idx, t, valid, max_cond,
                                       keep_first)
    want = S.select_closest_cond_frames(
        frame_idx, t, valid, max_cond_frame_num=max_cond,
        keep_first_cond_frame=keep_first)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
