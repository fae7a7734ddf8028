"""Twin of ``tests/test_run_all.py::test_run_all_with_tiny_vggt``: skix and
skix_torch run run_all's ``vggt`` stage on the same pt records with the
same checkpoint npz, and write the same ``multi_view_refined.npz``.

The checkpoint is a perturbed flax init of a tiny VGGT whose last pose
layer is solved so that the two views get a well-posed stereo rig; the
records' keypoints are a 3D skeleton projected through that rig. Without
that, random weights give near-degenerate cameras (fov → 0, points behind
a camera) on which triangulation amplifies any rounding without bound.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import random_variables

T, H, W, SIZE = 8, 56, 56, 28
TINY = dict(img_size=SIZE, embed_dim=32, depth=2, num_heads=2,
            intermediate_layer_idx=(0, 0, 1, 1))
# pose encodings [t(3), quat(4), fov_h, fov_w]: view 0 at the origin, view
# 1 turned 0.3 rad about y and moved one unit along x
POSES = np.array([
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0],
    [-1.0, 0.0, 0.1, math.cos(-0.15), 0.0, math.sin(-0.15), 0.0, 1.0, 1.0],
], np.float32)


def _variables(rng):
    """Random variables of a tiny skix VGGT with the adaLN modulation zeroed,
    so every refinement iteration adds the same delta and the head's last
    layer alone sets the pose."""
    from skix.models.vggt import VGGT

    v = random_variables(VGGT(**TINY, enable_depth=False, enable_point=False),
                         rng, jnp.zeros((1, 2, SIZE, SIZE, 3)))
    mod = v["params"]["camera_head"]["poseLN_modulation"]
    mod["kernel"][:] = 0.0
    mod["bias"][:] = 0.0
    return v


def _solve_last_layer(v, pair):
    """Set pose_branch.fc2 so that 4·fc2(g_s) = POSES[s] for the features
    g_s the port's float32 model feeds it on ``pair``."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models.vggt import VGGT

    model = VGGT(**TINY, enable_depth=False, enable_point=False)
    load_into(model, flax_to_state_dict(v))
    seen = []
    model.camera_head.pose_branch.fc2.register_forward_hook(
        lambda m, inp, out: seen.append(inp[0][0].detach().numpy()))
    with torch.no_grad():
        model(torch.as_tensor(pair)[None])
    g = seen[-1].astype(np.float64)                  # (2 views, hidden)
    dg = g[1] - g[0]
    target = POSES.astype(np.float64) / 4.0
    Wt = np.outer(target[1] - target[0], dg) / (dg @ dg)    # (9, hidden)
    b = target[0] - Wt @ g[0]
    fc2 = v["params"]["camera_head"]["pose_branch"]["fc2"]
    fc2["kernel"] = Wt.T.astype(np.float32)
    fc2["bias"] = b.astype(np.float32)


def _rig():
    from skix_torch.models.vggt import pose_encoding_to_extri_intri

    extr, K = pose_encoding_to_extri_intri(torch.as_tensor(POSES), (SIZE, SIZE))
    K = K.numpy().copy()
    K[:, 0] *= W / SIZE
    K[:, 1] *= H / SIZE
    R, t = extr[:, :, :3].numpy(), extr[:, :, 3].numpy()
    R_rel = R[1] @ R[0].T
    return K, R_rel, t[1] - R_rel @ t[0]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.io.contracts import PTInfo, save_pt_info
    from skix_torch.pipelines.vggt import preprocess_frames

    rng = np.random.default_rng(121)
    root = tmp_path_factory.mktemp("twin")
    frames = rng.integers(0, 255, (2, T, H, W, 3)).astype(np.uint8)
    v = _variables(rng)
    pair = torch.cat([preprocess_frames(frames[0, :1], SIZE, "cpu"),
                      preprocess_frames(frames[1, :1], SIZE, "cpu")]).numpy()
    _solve_last_layer(v, pair)
    save_checkpoint(str(root / "vggt.npz"), v)

    K, R_rel, t_rel = _rig()
    X = (rng.normal(size=(1, 17, 3)) * 0.5
         + rng.normal(size=(T, 17, 3)).cumsum(0) * 0.02
         + np.array([0.0, 0.0, 4.0]))
    xa = X @ K[0].T
    xb = (X @ R_rel.T + t_rel) @ K[1].T
    obs = np.stack([xa[..., :2] / xa[..., 2:], xb[..., :2] / xb[..., 2:]])
    obs = obs + rng.normal(size=obs.shape) * 0.3
    pt = root / "pt" / "p01"
    for c, view in enumerate(("osmo_1", "osmo_2")):
        score = np.ones((T, 17), np.float32)
        save_pt_info(pt / f"{view}.npz", PTInfo(
            video_name=view, frame_count=T, img_shape=(H, W), fps=30.0,
            duration=T / 30.0, frames=frames[c],
            d2_keypoints=np.concatenate(
                [obs[c].astype(np.float32), score[..., None]], -1),
            d2_keypoints_score=score))
    return root, X


def _run_all_cfg(root, work):
    return {"paths": {"pt_root": str(root / "pt"), "work_root": str(work),
                      "video_root": None, "sam3d_root": None},
            "stages": ["vggt"], "kpt_source": "detectron2",
            "vggt_img_size": SIZE, "vggt_embed_dim": 32, "vggt_depth": 2,
            "vggt_num_heads": 2, "vggt_taps": [0, 0, 1, 1],
            "vggt_frame_stride": 30, "vggt_checkpoint": str(root / "vggt.npz")}


def test_run_all_vggt_twin(records, tmp_path):
    """run_all as configured: bfloat16 VGGT, pose-only LM BA."""
    import yaml

    from skix.pipelines.run_all import main as skix_run_all
    from skix_torch.pipelines.run_all import main as torch_run_all

    root, X_true = records
    cdir = tmp_path / "configs"
    cdir.mkdir()
    (cdir / "run_all.yaml").write_text(
        yaml.safe_dump(_run_all_cfg(root, tmp_path / "skix")))
    skix_run_all([f"--config-dir={cdir}"])
    torch_run_all(dict(_run_all_cfg(root, tmp_path / "port"), device="cpu"))

    for name in ("pipeline_timing.json", "pipeline_summary.json",
                 "vggt/vggt_summary.json"):
        assert (tmp_path / "port" / name).exists(), name
    s_sum = json.loads((tmp_path / "skix/vggt/vggt_summary.json").read_text())
    t_sum = json.loads((tmp_path / "port/vggt/vggt_summary.json").read_text())
    assert s_sum.keys() == t_sum.keys() == {"p01"}
    a = np.load(tmp_path / "skix/vggt/p01/multi_view_refined.npz")
    b = np.load(tmp_path / "port/vggt/p01/multi_view_refined.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
    assert b["X3d"].shape == (T, 17, 3)
    assert b["final_cost"] <= b["initial_cost"]
    # both run the model in bfloat16, which rounds at other places in the
    # two frameworks: the cameras differ by a few bf16 steps (≈0.5%), and
    # X3d (scale ≈ 5 units) moves with them
    np.testing.assert_allclose(b["R"], a["R"], atol=5e-3)
    np.testing.assert_allclose(b["t"], a["t"], atol=1e-2)
    np.testing.assert_allclose(b["K"], a["K"], rtol=1e-5)
    np.testing.assert_allclose(b["K_right"], a["K_right"], rtol=1e-5)
    np.testing.assert_allclose(b["X3d"], a["X3d"], atol=0.15)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-2)
    # and both recover the rig's skeleton to the same accuracy
    err_s = np.abs(a["X3d"] - X_true).max()
    err_t = np.abs(b["X3d"] - X_true).max()
    assert err_t < 1.2 * err_s + 0.05, (err_t, err_s)


def test_process_multi_view_twin_float32(records, tmp_path):
    """The stage's arithmetic, both packages in float32."""
    from skix.config import Cfg
    from skix.pipelines import vggt as skix_vggt
    from skix_torch.config import config_from_mapping
    from skix_torch.pipelines import vggt as torch_vggt

    root, _ = records
    body = dict(TINY, intermediate_layer_idx=list(TINY["intermediate_layer_idx"]),
                dtype="float32", frame_stride=30, checkpoint=str(root / "vggt.npz"),
                enable_depth=False, enable_point=False, device="cpu")
    recs = sorted((root / "pt" / "p01").glob("*.npz"))
    s_cfg = Cfg(body)
    s_model = skix_vggt.build_model(s_cfg)
    s_rep = skix_vggt.process_multi_view(
        s_model, skix_vggt.load_or_init_variables(s_model, s_cfg), recs[0],
        recs[1], tmp_path / "skix", s_cfg)
    t_cfg = config_from_mapping(body)
    t_model = torch_vggt.load_or_init_variables(
        torch_vggt.build_model(t_cfg, torch.device("cpu")), t_cfg)
    t_rep = torch_vggt.process_multi_view(t_model, recs[0], recs[1],
                                          tmp_path / "port", t_cfg)
    a = np.load(tmp_path / "skix/multi_view_refined.npz")
    b = np.load(tmp_path / "port/multi_view_refined.npz")
    assert sorted(a.files) == sorted(b.files)
    assert t_rep["frames"] == s_rep["frames"] == T
    assert t_rep["vggt_pairs"] == s_rep["vggt_pairs"] == 1
    # float32 throughout: the model agrees to ~1e-6, the LM probes differ
    # (torch cannot draw JAX's stream), the converged values agree
    np.testing.assert_allclose(b["R"], a["R"], atol=1e-5)
    np.testing.assert_allclose(b["t"], a["t"], atol=1e-5)
    np.testing.assert_allclose(b["K"], a["K"], rtol=1e-6)
    np.testing.assert_allclose(b["K_right"], a["K_right"], rtol=1e-6)
    np.testing.assert_allclose(b["X3d"], a["X3d"], atol=5e-4)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4)


def test_unported_stages_and_modes_raise(tmp_path):
    from skix_torch.pipelines.run_all import main as torch_run_all
    from skix_torch.pipelines.vggt import main as torch_vggt

    cfg = {"paths": {"pt_root": str(tmp_path), "work_root": str(tmp_path)},
           "stages": ["vggt", "prepare_dataset"], "device": "cpu"}
    with pytest.raises(NotImplementedError, match="prepare_dataset"):
        torch_run_all(cfg)
    # every vggt mode is ported since the sfm slice; an unknown one raises
    with pytest.raises(ValueError, match="unknown vggt mode"):
        torch_vggt({"mode": "stereo", "device": "cpu",
                    "paths": {"pt_root": str(tmp_path),
                              "out_root": str(tmp_path)}})


def test_no_silent_cpu_path():
    """Entry points default to cuda; without a card they raise instead of
    running on the CPU."""
    from skix_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
