"""skix_torch's R|t solver, ICP and FOV estimator against skix on the CPU,
on the same seeded inputs: ``solve_rt_from_3d`` (cameras only and with the
points) within 1e-4 (translations of the baseline), ``icp`` (plain, gated,
``max_corr_dist``, ``allow_scale``) within 1e-5 with the same nearest
indices, the FOV estimator through the weight bridge within 1e-5. skix's
LM draws its Hutchinson probes from ``jax.random.PRNGKey(17)``; the port's
``rademacher_probes`` is patched to the same draws, so both solvers take
the same steps.

With ``refine_points`` skix leaves the similarity gauge of the cameras and
points free (no camera is held fixed): once the cost nears float32's
rounding floor, two float32 solvers drift apart along it (on 0.5 px noise
the cameras 3e-4 apart after 20 steps, 20 CG iterations). That case takes
skix's own full-mode problem (exact observations, perturbed points). The
solve from the RANSAC initialization is held to the port's own pieces
(``estimate_relative_pose`` is held to skix in test_torch_epipolar.py):
on this problem with 0.5 px of noise skix's float32 8-point fit starts at
a cost of 8734 where the port's float64 fit starts at 50 (ROADMAP Queue
3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import _CHEAP, jit0, port_variables

from skix.geometry import icp as sicp
from skix.geometry.rotations import rotvec_to_matrix as s_rotvec
from skix.models import fov as sfov
from skix.solvers import lm as slm
from skix.solvers import rt_solver as srt
from skix_torch.geometry import epipolar as tepi
from skix_torch.geometry import icp as ticp
from skix_torch.geometry.rotations import matrix_to_rotvec
from skix_torch.models import fov as tfov
from skix_torch.solvers import lm as tlm
from skix_torch.solvers import rt_solver as trt

# skix's LM at XLA's level 0: each solve traces a new residual closure and
# compiles once
_skix_lm = jax.jit(slm.levenberg_marquardt.__wrapped__,
                   static_argnums=(0, 3, 4, 10), compiler_options=_CHEAP)
_skix_icp = jit0(sicp.icp, static_argnames=("iterations", "max_corr_dist",
                                             "allow_scale"))


def _skix_probes(probes, n, dtype, device, seed=17):
    v = jax.random.rademacher(jax.random.PRNGKey(seed), (probes, n),
                              dtype=jnp.float32)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def _rt_problem(noise_px):
    """skix's TestRTSolver problem: 60 points 15 m out, a right camera 8 m
    to the side and turned 0.4 rad; observations with ``noise_px`` of
    noise, the points perturbed by 5 cm."""
    rng = np.random.default_rng(149)
    K = np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1]])
    R_r = np.asarray(s_rotvec(jnp.asarray([0.05, 0.4, 0.02])))
    t_r = np.array([-8.0, 0.3, 1.0])
    X = rng.normal(size=(60, 3)) * 1.5 + np.array([0, 0, 15.0])

    def proj(Xw, R, t):
        Xc = Xw @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:]
        return uv * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    noise = rng.normal(size=(2, 60, 2)) * noise_px
    uv_l = proj(X, np.eye(3), np.zeros(3)) + noise[0]
    uv_r = proj(X, R_r, t_r) + noise[1]
    Xn = X + rng.normal(size=X.shape) * 0.05
    conf = rng.uniform(0.3, 1.0, 60)
    return K, t_r, Xn, uv_l, uv_r, conf


def _init(t_r):
    return {"rl": np.zeros(3, np.float32), "tl": np.zeros(3, np.float32),
            "rr": np.array([0.08, 0.35, 0.0], np.float32),
            "tr": (t_r + [0.4, -0.2, 0.3]).astype(np.float32)}


@pytest.mark.parametrize("mode", ["cameras", "points"])
def test_solve_rt_twin(mode, monkeypatch):
    monkeypatch.setattr(srt, "levenberg_marquardt", _skix_lm)
    monkeypatch.setattr(tlm, "rademacher_probes", _skix_probes)
    points = mode == "points"
    K, t_r, X, uv_l, uv_r, conf = _rt_problem(0.0 if points else 0.5)
    kw = dict(conf=conf, refine_points=points, init=_init(t_r),
              max_steps=20 if points else 10, cg_iters=20 if points else 10,
              soft_l1_delta=4.0)
    want = srt.solve_rt_from_3d(X, uv_l, uv_r, K, **{
        k: ({a: jnp.asarray(b) for a, b in v.items()} if k == "init" else v)
        for k, v in kw.items()})
    got = trt.solve_rt_from_3d(X, uv_l, uv_r, K, device="cpu", **kw)
    assert float(got.final_cost) < float(got.initial_cost)
    # each field within 1e-4 of max(1, its largest element); translations
    # within 1e-4 of the baseline
    for name in want._fields:
        w = np.asarray(getattr(want, name), np.float64)
        g = getattr(got, name).numpy().astype(np.float64)
        scale = (np.linalg.norm(t_r) if name.startswith("t_")
                 else max(1.0, float(np.abs(w).max())))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_solve_rt_from_ransac_init():
    """Without ``init`` the cameras start from the RANSAC relative pose
    scaled to the baseline, the left camera at the origin."""
    K, t_r, X, uv_l, uv_r, conf = _rt_problem(0.5)
    kw = dict(conf=conf, max_steps=6, cg_iters=10, device="cpu")
    base = float(np.linalg.norm(t_r))
    got = trt.solve_rt_from_3d(X, uv_l, uv_r, K, baseline_m=base, **kw)
    f = [torch.as_tensor(a, dtype=torch.float32) for a in (uv_l, uv_r, K)]
    pose = tepi.estimate_relative_pose(*f)
    init = {"rl": torch.zeros(3), "tl": torch.zeros(3),
            "rr": matrix_to_rotvec(pose.R),
            "tr": tepi.scale_translation_to_baseline(pose.t, base)}
    want = trt.solve_rt_from_3d(X, uv_l, uv_r, K, init=init, **kw)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(got.final_cost) < float(got.initial_cost)


def test_rt_ravel_matches_ravel_pytree():
    from jax.flatten_util import ravel_pytree

    rng = np.random.default_rng(3)
    free = {k: rng.normal(size=s).astype(np.float32) for k, s in
            (("tr", 3), ("X", (5, 3)), ("rl", 3), ("tl", 3), ("rr", 3))}
    want, _ = ravel_pytree({k: jnp.asarray(v) for k, v in free.items()})
    got, unravel = trt.ravel({k: torch.as_tensor(v) for k, v in free.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravel(got)
    for k, v in free.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def _clouds(seed, N=300, M=280):
    """A target cloud and a source cloud: the target's first N points
    rotated 0.15 rad, shifted, jittered, plus outliers."""
    rng = np.random.default_rng(seed)
    tgt = rng.normal(size=(max(N, M), 3)).astype(np.float32) * [1.0, 0.6, 0.3]
    a = 0.15
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    src = (tgt[:N] - [0.1, -0.05, 0.08]) @ R + rng.normal(size=(N, 3)) * 0.01
    src[::17] += rng.normal(size=src[::17].shape)
    return src.astype(np.float32), tgt[:M].copy()


@pytest.mark.parametrize("case", ["plain", "gated", "max_corr_dist",
                                  "allow_scale"])
def test_icp_twin(case):
    src, tgt = _clouds(11)
    kw = {}
    if case == "gated":
        uv = src[:, :2] * 100 + 320
        kw["source_valid"] = np.asarray(sicp.bbox_gate_mask(
            jnp.asarray(uv), jnp.asarray([250.0, 250.0, 400.0, 390.0])))
        assert torch.equal(ticp.bbox_gate_mask(torch.as_tensor(uv),
                                               [250.0, 250.0, 400.0, 390.0]),
                           torch.as_tensor(kw["source_valid"]))
        kw["target_valid"] = np.arange(len(tgt)) % 7 != 0
    if case == "max_corr_dist":
        kw["max_corr_dist"] = 0.2
    if case == "allow_scale":
        src = src * 1.1
        kw["allow_scale"] = True
    want = _skix_icp(jnp.asarray(src), jnp.asarray(tgt), **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()}, iterations=6)
    got = ticp.icp(src, tgt, iterations=6, device="cpu", **kw)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    # the last iteration's correspondences, as skix's loop finds them
    R_prev = ticp.icp(src, tgt, iterations=5, device="cpu", **kw)
    moved = jnp.asarray(src) @ jnp.asarray(R_prev.R.numpy()).T + jnp.asarray(
        R_prev.t.numpy())
    tv = kw.get("target_valid", np.ones(len(tgt), bool))
    d2 = jnp.sum((moved[:, None] - jnp.where(tv[:, None], tgt, 1e12)[None])
                 ** 2, -1)
    np.testing.assert_array_equal(got.nn_idx.numpy(),
                                  np.asarray(jnp.argmin(d2, axis=1)))


def test_icp_first_index_on_ties_and_chunks(monkeypatch):
    """Duplicated targets tie exactly: the first index wins, also when the
    distances are built in chunks of a few rows."""
    tgt = np.repeat(np.random.default_rng(2).normal(size=(20, 3)), 3,
                    0).astype(np.float32)
    pts = torch.as_tensor(tgt[::3] + 1e-3)
    idx, d = ticp.nearest_neighbours(pts, torch.as_tensor(tgt))
    np.testing.assert_array_equal(idx.numpy(), np.arange(20) * 3)
    monkeypatch.setattr(ticp, "_CHUNK_ELEMS", 7 * 60)
    idx2, d2 = ticp.nearest_neighbours(pts, torch.as_tensor(tgt))
    assert torch.equal(idx, idx2) and torch.equal(d, d2)


def test_fov_twin():
    model = tfov.FovEstimator(width=16, depth=4)
    variables = port_variables(model, seed=5)
    smodel = sfov.FovEstimator(width=16, depth=4)
    frames = np.random.default_rng(4).integers(0, 255, (5, 27, 48, 3),
                                               dtype=np.uint8)
    apply = jit0(smodel.apply)
    want = sfov.estimate_focal_lengths(smodel, variables, frames,
                                       batch_size=2)
    port = tfov.load_fov_estimator(variables, width=16, depth=4,
                                   device="cpu")
    got = tfov.estimate_focal_lengths(port, frames, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    imgs = frames[:2].astype(np.float32) / 255.0
    with torch.no_grad():
        fov = port(torch.as_tensor(imgs)).numpy()
    np.testing.assert_allclose(fov, np.asarray(apply(variables, imgs)),
                               rtol=0, atol=1e-5)
    f = np.array([500.0, 1116.93, 3000.0], np.float32)
    np.testing.assert_allclose(tfov.focal_to_fov(f, 1920).numpy(),
                               np.asarray(sfov.focal_to_fov(f, 1920)),
                               rtol=1e-6)
    np.testing.assert_allclose(tfov.fov_to_focal(fov[:, 0], 270).numpy(),
                               np.asarray(sfov.fov_to_focal(fov[:, 0], 270)),
                               rtol=1e-6)
