"""Twin of ``tests/test_pipelines.py::TestFuseAngleMetricsCLIs``: skix
and skix_torch run fuse, then angle on the 15-joint subset, then metrics,
on the same inputs, and write the same files."""

import json

import numpy as np

import jax.numpy as jnp

from _torch_parity import assert_same_outputs, run_stage_twins


def test_fuse_angle_metrics_cli_twins(tmp_path):
    """TestFuseAngleMetricsCLIs' chain: fuse (arrays within 1e-4), angle on
    the 15-joint subset (series within 1e-3 degrees, turns equal), metrics
    (within 1e-4)."""
    from skix.angle.biomech import TARGET_IDS
    from skix.geometry.rotations import rotvec_to_matrix
    from skix.pipelines.angle import main as skix_angle
    from skix.pipelines.fuse import main as skix_fuse
    from skix.pipelines.metrics import main as skix_metrics
    from skix_torch.pipelines.angle import main as port_angle
    from skix_torch.pipelines.fuse import main as port_fuse
    from skix_torch.pipelines.metrics import main as port_metrics

    rng = np.random.default_rng(8)
    T = 60
    in_root = tmp_path / "sam3d"
    base = rng.normal(size=(T, 70, 3)).cumsum(0) * 0.02
    R = np.asarray(rotvec_to_matrix(jnp.asarray([0.1, 0.5, -0.05])))
    pdir = in_root / "p01"
    pdir.mkdir(parents=True)
    np.save(pdir / "left_view.npy",
            (base + rng.normal(size=base.shape) * 0.01).astype(np.float32))
    np.save(pdir / "right_view.npy",
            (base @ R.T + 1.0 + rng.normal(size=base.shape) * 0.01
             ).astype(np.float32))

    want, got = run_stage_twins(tmp_path, "fuse", f"""
paths:
  in_root: {in_root}
  out_root: {{out}}
""", skix_fuse, port_fuse)
    assert_same_outputs(want, got)

    angle_in = tmp_path / "angle_in" / "p01"
    angle_in.mkdir(parents=True)
    smoothed = np.load(want / "p01" / "p01_smoothed.npy")
    np.save(angle_in / "p01_smoothed.npy", smoothed[:, list(TARGET_IDS)])
    np.save(angle_in / "p01_fused.npy",
            np.load(want / "p01" / "p01_fused.npy")[:, list(TARGET_IDS)])
    a_want, a_got = run_stage_twins(tmp_path / "angle", "angle", f"""
paths:
  fused_root: {tmp_path / 'angle_in'}
  out_root: {{out}}
up_axis: [0.0, 1.0, 0.0]
plots: false
compare_prefusion: true
""", skix_angle, port_angle)
    assert_same_outputs(a_want, a_got, atol=1e-3)
    assert (a_got / "p01" / "before_after_comparison.json").exists()

    m_want, m_got = run_stage_twins(tmp_path / "metrics", "metrics", f"""
paths:
  in_root: {want}
  out_root: {{out}}
gt_root: null
""", skix_metrics, port_metrics)
    assert_same_outputs(m_want, m_got)
    rep = json.loads((m_got / "metrics_report.json").read_text())
    assert rep["p01"]["smoothed"]["jitter"] < rep["p01"]["fused"]["jitter"]
