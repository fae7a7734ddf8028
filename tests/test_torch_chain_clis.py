"""Twins of ``tests/test_pipelines.py``'s stage CLI tests of the run_all
chain, part one: TestVideoPose3DCLI and TestBACLI. skix and skix_torch run
the same stage on the same inputs (and the same lifter checkpoint), and
write the same files with the same contents (limits per test below); the
other twins are in ``test_torch_chain_cli_triangulation.py`` and
``test_torch_chain_cli_fuse.py``."""

import json

import numpy as np

import jax
import jax.numpy as jnp

from _torch_parity import assert_same_outputs, run_stage_twins
from test_pipelines import make_synthetic_person


def test_videopose3d_cli_twin(tmp_path):
    """A skix-initialized lifter checkpoint (flax params + batch stats) lifts
    both views identically: per-view npy, fused npz and metrics within 1e-4;
    without a checkpoint the port's seeded lifter writes the same schema."""
    from skix.models.videopose3d import TemporalLifter
    from skix.pipelines.videopose3d import main as skix_main
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.pipelines.videopose3d import main as port_main

    pt_root = make_synthetic_person(tmp_path)
    model = TemporalLifter(filter_widths=(3, 3, 3), channels=64)
    save_checkpoint(str(tmp_path / "lifter.npz"), model.init(
        jax.random.PRNGKey(0), np.zeros((1, model.rf, 17, 2), np.float32),
        train=False))
    body = f"""
paths:
  pt_root: {pt_root}
  out_root: {{out}}
checkpoint: {tmp_path / 'lifter.npz'}
kpt_source: detectron2
filter_widths: [3, 3, 3]
channels: 64
test_time_augmentation: true
fuse_tau: 0.08
"""
    want, got = run_stage_twins(tmp_path, "videopose3d", body, skix_main, port_main)
    assert_same_outputs(want, got, atol=1e-4)
    fused = np.load(got / "p01" / "p01_fused.npz")["fused"]
    assert fused.shape == (40, 17, 3) and np.isfinite(fused).all()

    seeded = tmp_path / "seeded"
    port_main({"paths": {"pt_root": str(pt_root), "out_root": str(seeded)},
               "filter_widths": [3, 3, 3], "channels": 64, "device": "cpu"})
    fused = np.load(seeded / "p01" / "p01_fused.npz")["fused"]
    assert fused.shape == (40, 17, 3) and np.isfinite(fused).all()
    assert "p01" in json.loads((seeded / "summary.json").read_text())


def test_bundle_adjustment_cli_twin(tmp_path):
    """TestBACLI's problem, LM: the refined joints within 1e-4 and the costs
    within 2e-2 of skix's (the LM probes differ: torch cannot draw JAX's
    stream, so the solvers agree where they converge)."""
    from skix.geometry.rotations import rotvec_to_matrix
    from skix.pipelines.bundle_adjustment import main as skix_main
    from skix.solvers.ba import project_tcj
    from skix_torch.pipelines.bundle_adjustment import main as port_main

    rng = np.random.default_rng(9)
    T, J = 10, 17
    K = np.array([[1100.0, 0, 960], [0, 1100.0, 540], [0, 0, 1]])
    R = np.stack([np.eye(3),
                  np.asarray(rotvec_to_matrix(jnp.asarray([0.05, 0.4, 0.0])))])
    t = np.array([[0.0, 0, 0], [-15.0, 0.5, 2.0]])
    X = rng.normal(size=(T, J, 3)) * 0.4 + np.array([0, 0, 18.0])
    x2d = np.asarray(project_tcj(jnp.asarray(X), jnp.asarray(R),
                                 jnp.asarray(t), jnp.asarray(K)))
    in_root = tmp_path / "ba_in" / "p01"
    in_root.mkdir(parents=True)
    np.savez(in_root / "clip.npz",
             X3d=(X + rng.normal(size=X.shape) * 0.05).astype(np.float32),
             R=R.astype(np.float32), t=t.astype(np.float32),
             K=K.astype(np.float32), x2d=x2d.astype(np.float32))
    body = f"""
paths:
  in_root: {tmp_path / 'ba_in'}
  out_root: {{out}}
mode: pose_only
method: lm
weights:
  reproj: 1.0
  cam_smooth: 0.1
  baseline: 0.01
  bone: 0.001
  temporal: 0.001
lm:
  max_steps: 30
  cg_iters: 25
adam:
  iters: 100
  lr: 0.01
"""
    want, got = run_stage_twins(tmp_path, "bundle_adjustment", body, skix_main,
                          port_main)
    reports = ("clip_ba_report.json", "ba_summary.json")
    assert_same_outputs(want, got, ignore=reports)
    rep_s = json.loads((want / "p01" / "clip_ba_report.json").read_text())
    rep_t = json.loads((got / "p01" / "clip_ba_report.json").read_text())
    assert set(rep_s) == set(rep_t)
    np.testing.assert_allclose(rep_t["initial_cost"], rep_s["initial_cost"],
                               rtol=1e-5)
    for k in ("final_cost", "reprojection", "bone_length", "pose_temporal"):
        np.testing.assert_allclose(rep_t[k], rep_s[k], rtol=2e-2, atol=1e-6,
                                   err_msg=k)
    assert rep_t["final_cost"] < rep_t["initial_cost"]
    refined = np.load(got / "p01" / "clip_refined.npz")
    assert np.linalg.norm(refined["X3d"] - X, axis=-1).mean() < 0.02
