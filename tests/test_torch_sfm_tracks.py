"""skix_torch's SfM track prediction and COLMAP export against skix's, on
the CPU.

Shi–Tomasi (with exact ties: the lowest flat index wins, as in
``jax.lax.top_k``), frame ranking and farthest-point sampling, the query
frame swap, ``predict_tracks`` with a stub head (confidence gating, the
non-visible augmentation) and with a real tiny track head, and
``colmap_export`` down to the text files. Keypoints and choices equal;
numbers 1e-5 (tracks 1e-4 relative to the image size).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, random_variables

from skix_torch.perception import sfm_tracks as P

rng = np.random.default_rng(5150)


def _checker(H=40, W=48, cell=6):
    """A checkerboard: every interior corner has the same neighbourhood,
    so Shi–Tomasi's peaks tie exactly."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (((yy // cell) + (xx // cell)) % 2).astype(np.float32)


@pytest.mark.parametrize("max_pts", [8, 64])
def test_shi_tomasi_ties_take_the_lowest_index(max_pts):
    """On a checkerboard the peaks tie exactly (the port's scores are sums
    of shifted slices, the same at every position; XLA's convolution
    rounds differently from position to position, so skix's plateaus are
    not exact and its picks are not compared here): the tied peaks come in
    flat-index order, and the tie rule is ``jax.lax.top_k``'s."""
    img = _checker()
    xy, score, valid = (a.numpy() for a in P.shi_tomasi_keypoints(
        img, max_pts=max_pts))
    assert valid.sum() >= 8
    idx = xy[valid][:, 1] * img.shape[1] + xy[valid][:, 0]
    tied = score[valid] == score[0]
    assert tied.sum() >= 8 and np.all(np.diff(idx[tied]) > 0)

    flat = np.round(rng.normal(size=500), 1).astype(np.float32)
    flat[::7] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(flat), max_pts)
    got_v, got_i = P.top_k(torch.as_tensor(flat), max_pts)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_shi_tomasi_rgb_texture():
    from skix.perception.sfm_tracks import shi_tomasi_keypoints as skix_st

    low = rng.random((6, 7, 3))
    img = np.kron(low, np.ones((8, 8, 1))).astype(np.float32)
    img += 0.05 * rng.random(img.shape).astype(np.float32)
    want = [np.asarray(a) for a in skix_st(img, max_pts=40)]
    got = [a.numpy() for a in P.shi_tomasi_keypoints(img, max_pts=40)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)


def test_top_k_is_stable():
    v = torch.tensor([1.0, 3.0, 3.0, -float("inf"), 3.0, 2.0])
    vals, idx = P.top_k(v, 4)
    assert idx.tolist() == [1, 2, 4, 5] and vals.tolist() == [3, 3, 3, 2]


def test_ranking_and_farthest_point_sampling():
    from skix.perception import sfm_tracks as S

    feats = rng.normal(size=(7, 16))
    for n in (1, 3, 7):
        assert P.rank_frames_by_similarity(feats, n) == \
            S.rank_frames_by_similarity(feats, n)
    tokens = rng.normal(size=(5, 6, 8))
    assert P.rank_frames_by_similarity(tokens, 4, True) == \
        S.rank_frames_by_similarity(tokens, 4, True)
    dm = rng.random((6, 6))
    dm[2, :] = dm[4, :] = 0.5            # ties: argmax takes the first
    assert P.farthest_point_sampling(dm, 5, 1) == \
        S.farthest_point_sampling(dm, 5, 1)
    order = P.calculate_index_mappings(3, 6)
    np.testing.assert_array_equal(order, S.calculate_index_mappings(3, 6))
    np.testing.assert_array_equal(order[order], np.arange(6))


class _SkixStub(fnn.Module):
    """skix's test stub: tracks stay at the queries; a frame's visibility
    is its first tap's mean."""

    @fnn.compact
    def __call__(self, taps, queries, query_valid=None, iters=None):
        self.param("dummy", fnn.initializers.zeros, (1,))
        t0 = taps[0]
        B, S = t0.shape[0], t0.shape[1]
        N = queries.shape[1]
        pos = jnp.broadcast_to(queries[:, None], (B, S, N, 2))
        vis = jnp.broadcast_to(jnp.mean(t0, axis=(2, 3))[:, :, None],
                               (B, S, N))
        return [pos], vis, None


class _PortStub:
    """The same stub on the port's split interface."""

    def features(self, taps):
        return taps[0]

    def track(self, fmaps, queries, query_valid=None):
        B, S = fmaps.shape[:2]
        N = queries.shape[1]
        vis = fmaps.mean(dim=(2, 3))[:, :, None].expand(B, S, N)
        return [queries[:, None].expand(B, S, N, 2)], vis, None


def _clip(S=4, H=32, W=32):
    base = rng.random((H, W)).astype(np.float32)
    return np.stack([np.roll(base, s, axis=1) for s in range(S)])


def _both(images, feats, **kw):
    from skix.perception.sfm_tracks import predict_tracks as skix_pt

    S = images.shape[0]
    model = _SkixStub()
    v = model.init(jax.random.PRNGKey(0),
                   tuple(jnp.zeros((1, S, 64, 4)) for _ in range(4)),
                   jnp.zeros((1, 4, 2)))
    want = skix_pt(model, v, images, feats, **kw)
    got = P.predict_tracks(_PortStub(), images, torch.as_tensor(feats), **kw)
    return want, got


def _same(got, want):
    for name in ("tracks", "vis_scores", "confs", "points_3d", "colors"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def test_predict_tracks_conf_gating():
    images = _clip()
    S, H, W = images.shape
    feats = np.ones((4, S, 64, 4), np.float32)
    conf = np.zeros((S, H, W), np.float32)
    conf[:, :, : W // 2] = 2.0
    p3d = rng.normal(size=(S, H, W, 3)).astype(np.float32)
    want, got = _both(images, feats, conf=conf, points_3d=p3d,
                      max_query_pts=64, query_frame_num=2, chunk=16,
                      conf_thresh=1.2, min_conf_keep=2,
                      complete_non_vis=False)
    _same(got, want)
    assert (got.confs > 1.2).all() and got.tracks.shape[1] > 0


def test_predict_tracks_non_visible_augmentation():
    """Frame 2 stays invisible to the stub: the loop re-queries it, then
    makes its final all-in trial and stops, as skix's does."""
    images = _clip()
    S = images.shape[0]
    feats = np.ones((4, S, 64, 4), np.float32)
    feats[:, 2] = 0.0
    want, got = _both(images, feats, max_query_pts=16, query_frame_num=1,
                      chunk=16, complete_non_vis=True, min_vis=4,
                      non_vis_thresh=0.5, final_max_pts=32)
    _same(got, want)
    assert got.tracks.shape[1] > 16


def test_predict_tracks_real_head():
    """A tiny track head (one refinement step) with skix's random variables,
    skix's per-chunk calls against the port's shared feature maps."""
    from skix.models.track_head import TrackHead as SkixHead
    from skix.perception.sfm_tracks import predict_tracks as skix_pt
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models.track_head import TrackHead

    images = _clip(S=3)
    S = images.shape[0]
    feats = rng.random((4, S, 64, 8)).astype(np.float32)
    kw = dict(dim_in=8, patch_size=4, features=8, iters=1, corr_levels=3,
              corr_radius=1, hidden_size=16, img_hw=(32, 32),
              patch_start_idx=0)
    shead = SkixHead(**kw)
    v = random_variables(shead, rng, tuple(jnp.zeros((1, S, 64, 8))
                                           for _ in range(4)),
                         jnp.zeros((1, 4, 2)))
    head = TrackHead(**kw)
    assert load_into(head, flax_to_state_dict(v)) == []
    args = dict(max_query_pts=16, query_frame_num=2, chunk=8,
                complete_non_vis=False)
    want = skix_pt(shead, v, images, feats, **args)
    with torch.no_grad():
        got = P.predict_tracks(head.eval(), images, torch.as_tensor(feats),
                               **args)
    np.testing.assert_array_equal(got.colors, want.colors)
    close_scaled(got.tracks, want.tracks, 1e-4)
    close_scaled(got.vis_scores, want.vis_scores, 1e-5)


def _scene(N=3, Pn=12, seed=0):
    r = np.random.default_rng(seed)
    pts = r.normal(0.0, 0.5, (Pn, 3)) + np.array([0.0, 0.0, 5.0])
    K = np.array([[100.0, 0, 32.0], [0, 100.0, 32.0], [0, 0, 1.0]])
    extr, tracks = [], []
    for i in range(N):
        th = 0.1 * i
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        t = np.array([0.2 * i, 0.0, 0.0])
        uv = (pts @ R.T + t) @ K.T
        extr.append(np.concatenate([R, t[:, None]], axis=1))
        tracks.append(uv[:, :2] / uv[:, 2:3])
    return pts, np.stack(extr), np.stack([K] * N), np.stack(tracks)


def _text_rows(path):
    def tok(t):
        try:
            return float(t)
        except ValueError:
            return t
    return [ln if ln.startswith("#") else [tok(t) for t in ln.split()]
            for ln in path.read_text().splitlines()]


def _same_text(a, b, atol=1e-6):
    ra, rb = _text_rows(a), _text_rows(b)
    assert len(ra) == len(rb)
    for la, lb in zip(ra, rb):
        assert type(la) is type(lb) and len(la) == len(lb)
        if isinstance(la, str):
            assert la == lb
            continue
        for x, y in zip(la, lb):
            if isinstance(x, float):
                assert abs(x - y) <= atol, (a.name, x, y)
            else:
                assert x == y


@pytest.mark.parametrize("kw", [
    dict(max_reproj_error=2.0, min_inlier_per_frame=2),
    dict(max_reproj_error=2.0, min_inlier_per_frame=2, shared_camera=True,
         camera_type="PINHOLE"),
    dict(max_reproj_error=None, min_inlier_per_frame=2),
])
def test_colmap_reconstruction_to_text(tmp_path, kw):
    from skix.io import colmap_export as SC
    from skix_torch.io import colmap_export as TC

    pts, extr, intr, tracks = _scene()
    tracks = tracks.copy()
    tracks[1, 0] += 50.0                 # an outlier observation
    pts = pts.copy()
    pts[3, 2] = -5.0                     # behind the cameras
    masks = np.ones(tracks.shape[:2], bool)
    masks[2, 5] = False
    rgb = rng.integers(0, 255, (len(pts), 3)).astype(np.uint8)
    args = dict(image_size=(64, 64), masks=masks, points_rgb=rgb, **kw)
    want, wvalid = SC.build_reconstruction(pts, extr, intr, tracks, **args)
    got, gvalid = TC.build_reconstruction(pts, extr, intr, tracks, **args)
    np.testing.assert_array_equal(gvalid, wvalid)
    SC.write_reconstruction_text(want, tmp_path / "skix")
    TC.write_reconstruction_text(got, tmp_path / "port")
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        _same_text(tmp_path / "skix" / name, tmp_path / "port" / name)
    for a, b in zip(SC.reconstruction_to_arrays(want, kw.get("camera_type", "SIMPLE_PINHOLE")),
                    TC.reconstruction_to_arrays(got, kw.get("camera_type", "SIMPLE_PINHOLE"))):
        np.testing.assert_allclose(b, a, atol=1e-6)
    q_a, t_a, n_a = SC.read_colmap_images_txt(tmp_path / "skix" / "images.txt")
    q_b, t_b, n_b = TC.read_colmap_images_txt(tmp_path / "port" / "images.txt")
    assert n_a == n_b
    np.testing.assert_allclose(q_b, q_a, atol=1e-6)
    np.testing.assert_allclose(t_b, t_a, atol=1e-6)
    # the min-inlier gate
    assert TC.build_reconstruction(pts, extr, intr, tracks, image_size=(64, 64),
                                   max_reproj_error=2.0,
                                   min_inlier_per_frame=10 ** 6) == (None, None)


def test_export_colmap_text(tmp_path):
    from skix.io import colmap_export as SC
    from skix_torch.io import colmap_export as TC

    pts, extr, intr, _ = _scene()
    cols = rng.integers(0, 255, (len(pts), 3)).astype(np.uint8)
    for mod, d in ((SC, "skix"), (TC, "port")):
        mod.export_colmap_text(tmp_path / d, intr[0], (64, 80),
                               extr[:, :, :3], extr[:, :, 3],
                               points3d=pts, point_colors=cols)
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        _same_text(tmp_path / "skix" / name, tmp_path / "port" / name)
