"""Twin of ``tests/test_pipelines.py::TestTriangulationCLI``: skix and
skix_torch run the triangulation stage's ``kpt`` route on the same exact
two-view geometry and write the same files; the port's RANSAC gets skix's
own hypothesis draws through a patched ``ransac_samples``."""

import functools
import json

import numpy as np

import jax
import jax.numpy as jnp

from _torch_parity import _CHEAP, assert_same_outputs, run_stage_twins


@functools.partial(jax.jit, static_argnums=(2,), compiler_options=_CHEAP)
def _skix_draws(keys, weights, num_hypotheses):
    """skix/geometry/epipolar.py:170-173 for each (key, weights) row."""
    def one(key, w):
        logits = jnp.where(w > 0, 0.0, -1e9)
        return jax.vmap(lambda k: jax.random.categorical(
            k, logits, shape=(8,)))(jax.random.split(key, num_hypotheses))

    return jax.vmap(one)(keys, weights)


def skix_ransac_samples(weights, num_hypotheses, generator=None):
    """The draws skix's stage makes where the port calls ``ransac_samples``:
    per frame (256 hypotheses, keys split from PRNGKey(0)), the pooled clip
    pose (1024, PRNGKey(0)), per-view ego-motion (128, split from
    PRNGKey(7)); skix/pipelines/triangulation.py:98, :129, :310."""
    import torch

    w = jnp.asarray(weights.cpu().numpy())
    if num_hypotheses == 1024:
        out = _skix_draws(jax.random.PRNGKey(0)[None], w[None],
                          num_hypotheses)[0]
    else:
        seed = {256: 0, 128: 7}[num_hypotheses]
        out = _skix_draws(jax.random.split(jax.random.PRNGKey(seed),
                                           w.shape[0]), w, num_hypotheses)
    return torch.as_tensor(np.array(out), dtype=torch.long,
                           device=weights.device)


def test_triangulation_cli_twin(tmp_path, monkeypatch):
    """TestTriangulationCLI's exact two-view geometry through the ``kpt``
    route. The pooled clip pose, the triangulated joints, their validity
    and the BA input agree with skix's; the per-frame poses (17 joints of
    one frame, where skix's float32 8-point fit finds no inlier set: see
    ``tests/test_torch_epipolar.py``) and the per-view ego-motion logs are
    written with skix's schema."""
    from skix.geometry.rotations import rotvec_to_matrix
    from skix.io import PTInfo, save_pt_info
    from skix.pipelines.triangulation import default_K
    from skix.pipelines.triangulation import main as skix_main
    from skix_torch.geometry import epipolar
    from skix_torch.pipelines.triangulation import main as port_main

    monkeypatch.setattr(epipolar, "ransac_samples", skix_ransac_samples)
    rng = np.random.default_rng(7)
    T = 12
    K = default_K()
    R = np.asarray(rotvec_to_matrix(jnp.asarray([0.03, 0.35, 0.01])))
    t = np.array([-6.0, 0.2, 1.0])
    drift = np.linspace(-4, 4, T)[:, None, None] * np.array([1.0, 0.3, 0.6])
    X = rng.normal(size=(T, 17, 3)) * 1.5 + drift + np.array([0, 0, 14.0])

    def proj(Xw, Rm, tv):
        Xc = Xw @ Rm.T + tv
        uv = Xc[..., :2] / Xc[..., 2:]
        return uv * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    pt_root = tmp_path / "pt" / "p01"
    pt_root.mkdir(parents=True)
    for name, (Rm, tv) in (("osmo_1", (np.eye(3), np.zeros(3))),
                           ("osmo_2", (R, t))):
        kpts = proj(X, Rm, tv).astype(np.float32)
        score = np.ones((T, 17), np.float32)
        save_pt_info(pt_root / f"{name}.npz", PTInfo(
            video_name=name, frame_count=T, img_shape=(1080, 1920), fps=30.0,
            duration=T / 30.0, d2_keypoints=np.concatenate(
                [kpts, score[..., None]], -1), d2_keypoints_score=score))
    body = f"""
paths:
  pt_root: {tmp_path / 'pt'}
  out_root: {{out}}
kpt_source: detectron2
baseline_m: {np.linalg.norm(t)}
methods: [kpt]
K:
  - [1116.93, 0.0, 955.77]
  - [0.0, 1117.33, 538.91]
  - [0.0, 0.0, 1.0]
dist: null
"""
    want, got = run_stage_twins(tmp_path, "triangulation", body, skix_main, port_main)
    per_frame = ("p01_poses.npz", "p01_poses.csv",
                 "osmo_1_single_view_poses.npz", "osmo_2_single_view_poses.npz")
    # skix fits E in float32: its pooled pose is up to 1.5e-3 of the 6.1 m
    # baseline off the exact one, the port's (float64 normal equations)
    # within 1e-4 (asserted below). At 14 m from the rig that moves X by up
    # to a few mm and the mean reprojection error by ~0.01 px
    assert_same_outputs(want, got, ignore=per_frame + ("joints_3d_kpt.json",),
                        limits={"joints_3d_kpt_smoothed.npy": 5e-3,
                                "ba_input_kpt.npz": 5e-3})
    docs = [json.loads((d / "p01" / "joints_3d_kpt.json").read_text())
            for d in (want, got)]
    assert set(docs[0]) == set(docs[1])
    assert docs[0]["video_paths"][0].endswith("osmo_1.npz")
    np.testing.assert_allclose(docs[1]["R"], docs[0]["R"], atol=1e-4)
    np.testing.assert_allclose(docs[1]["t"], docs[0]["t"], atol=5e-3)
    for key, limit in (("joints_3d", 5e-3), ("mean_reproj_px", 2e-2)):
        np.testing.assert_allclose(*[[f[key] for f in d["frames"]]
                                     for d in docs[::-1]], atol=limit)
    np.testing.assert_array_equal(*[[f["valid"] for f in d["frames"]]
                                    for d in docs])
    with np.load(want / "p01" / "p01_poses.npz") as zs, \
            np.load(got / "p01" / "p01_poses.npz") as zt:
        assert set(zs.files) == set(zt.files)
        for k in zs.files:
            assert zs[k].shape == zt[k].shape, k
        np.testing.assert_array_equal(zt["methods"], zs["methods"])
        clip = list(zs["methods"]).index("kpt_clip")
        np.testing.assert_allclose(zt["R"][clip], zs["R"][clip], atol=1e-4)
        # t is scaled to the 6.1 m baseline (skix's is 1.5e-3 off, above)
        np.testing.assert_allclose(zt["t"][clip], zs["t"][clip], atol=5e-3)
        np.testing.assert_allclose(zt["t"][clip], t, atol=1e-4)
        np.testing.assert_allclose(zt["R"][clip], R, atol=1e-5)
    for view in ("osmo_1", "osmo_2"):
        with np.load(got / "p01" / f"{view}_single_view_poses.npz") as z:
            assert z["R"].shape == (T - 1, 3, 3) and z["t"].shape == (T - 1, 3)
    doc = json.loads((got / "p01" / "joints_3d_kpt.json").read_text())
    err = np.linalg.norm(np.array([f["joints_3d"] for f in doc["frames"]]) - X,
                         axis=-1).mean()
    assert err < 1.0, err
