"""Twin of ``tests/test_run_all.py::test_run_all_full_chain``: skix and
skix_torch run run_all's chain (videopose3d → triangulation →
bundle_adjustment → fuse → front_side → angle → metrics) on the same
fixture with the same lifter checkpoint, and write the same artifacts:
the fused MPJPE < 50 mm and equal to skix's within 1e-4 m, every stage's
outputs within the limits below."""

import json

import numpy as np
import pytest

import jax

from _torch_parity import assert_same_outputs
from test_run_all import _make_fixture

STAGES = ["videopose3d", "triangulation", "bundle_adjustment", "fuse",
          "front_side", "angle", "metrics"]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    import yaml

    from skix.models.videopose3d import TemporalLifter
    from skix.pipelines.run_all import main as skix_run_all
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.pipelines.run_all import PORTED_STAGES
    from skix_torch.pipelines.run_all import main as port_run_all

    assert set(STAGES) <= set(PORTED_STAGES)
    tmp = tmp_path_factory.mktemp("chain")
    gt, left = _make_fixture(tmp, 24)
    model = TemporalLifter(filter_widths=(3, 3), channels=32)
    save_checkpoint(str(tmp / "lifter.npz"), model.init(
        jax.random.PRNGKey(0), np.zeros((1, model.rf, 17, 2), np.float32),
        train=False))

    def cfg(work):
        return {"paths": {"pt_root": str(tmp / "pt"), "work_root": str(work),
                          "video_root": None, "sam3d_root": str(tmp / "sam3d"),
                          "front_root": str(tmp / "front")},
                "stages": STAGES, "lifter_checkpoint": str(tmp / "lifter.npz"),
                "filter_widths": [3, 3], "channels": 32,
                "kpt_source": "detectron2", "baseline_m": 20.0,
                "tri_methods": ["fixed"], "single_view": False,
                "ba_max_steps": 8, "ba_cg_iters": 10, "plots": False,
                "render_video": False, "gt_root": None, "device": "cpu"}

    cdir = tmp / "configs"
    cdir.mkdir()
    (cdir / "run_all.yaml").write_text(yaml.safe_dump(cfg(tmp / "skix")))
    skix_run_all([f"--config-dir={cdir}"])
    port_run_all(cfg(tmp / "port"))
    return tmp / "skix", tmp / "port", gt, left


def test_fused_mpjpe_below_50mm_and_equal_to_skix(chains):
    want, got, gt, left = chains
    timing = json.loads((got / "pipeline_timing.json").read_text())
    for stage in STAGES:
        assert stage in timing and timing[stage]["total_s"] > 0, stage
    mpjpe = {}
    for side, work in (("skix", want), ("port", got)):
        fused = np.load(work / "fused" / "p01" / "p01_fused.npy")
        mpjpe[side] = float(np.mean(np.linalg.norm(fused - gt, axis=-1)))
    mpjpe_left = float(np.mean(np.linalg.norm(left - gt, axis=-1)))
    assert mpjpe["port"] < mpjpe_left and mpjpe["port"] < 0.050, mpjpe
    assert abs(mpjpe["port"] - mpjpe["skix"]) < 1e-4, mpjpe


@pytest.mark.parametrize("stage", ["videopose3d", "fused", "front_side",
                                   "metrics"])
def test_stage_outputs_equal_skix(chains, stage):
    """The lifter's outputs, the fusion, the BEV merge and the metrics:
    every file within 1e-4, the BEV video byte for byte."""
    want, got, _, _ = chains
    assert_same_outputs(want / stage, got / stage, atol=1e-4)
    for video in (want / stage).rglob("*.mp4"):     # the same frames
        assert video.read_bytes() == (got / video.relative_to(want)).read_bytes()


def test_angle_outputs_equal_skix(chains):
    """Series within 1e-3 degrees, turns equal; the summary names each
    side's own fused input."""
    want, got, _, _ = chains
    assert_same_outputs(want / "angle", got / "angle", atol=1e-3,
                        ignore=("angle_summary.json",))
    s = json.loads((want / "angle" / "angle_summary.json").read_text())
    t = json.loads((got / "angle" / "angle_summary.json").read_text())
    assert t["p01"].pop("compared_with").startswith(str(got))
    assert s["p01"].pop("compared_with").startswith(str(want))
    assert t["p01"] == pytest.approx(s["p01"], abs=1e-3)


def test_triangulation_and_ba_outputs_match_skix(chains):
    """The fixture's random 2D tracks through the fixed demo rig put joints
    up to ~12.5 km from the cameras, where skix's float32 DLT is 1.2e-3 of
    the distance from the port's (whose normal equations are float64):
    joints within 2e-3 of their distance, validity equal; the BA (its
    points behind a camera, its cost ~4e22 and never lowered in 8 steps)
    holds the same costs within 2e-3 and the same joints."""
    want, got, _, _ = chains
    docs = [json.loads((w / "joints_3d" / "p01" / "joints_3d_fixed.json")
                       .read_text()) for w in (want, got)]
    Xs, Xt = (np.array([f["joints_3d"] for f in d["frames"]]) for d in docs)
    scale = np.maximum(1.0, np.linalg.norm(Xs, axis=-1, keepdims=True))
    assert np.all(np.abs(Xt - Xs) <= 2e-3 * scale)
    np.testing.assert_array_equal(*[[f["valid"] for f in d["frames"]]
                                    for d in docs])
    np.testing.assert_allclose(docs[1]["R"], docs[0]["R"])
    np.testing.assert_allclose(docs[1]["t"], docs[0]["t"])
    for name in ("joints_3d_fixed_smoothed.npy", "p01_poses.csv"):
        assert (got / "joints_3d" / "p01" / name).exists()
    rep_s, rep_t = (json.loads((w / "ba" / "p01" /
                                "ba_input_fixed_ba_report.json").read_text())
                    for w in (want, got))
    assert set(rep_s) == set(rep_t) and rep_t["iterations"] == 8
    for k in ("initial_cost", "final_cost", "reprojection", "bone_length",
              "pose_temporal"):
        np.testing.assert_allclose(rep_t[k], rep_s[k], rtol=2e-3, err_msg=k)
    assert rep_t["final_cost"] <= rep_t["initial_cost"]
    with np.load(want / "ba" / "p01" / "ba_input_fixed_refined.npz") as zs, \
            np.load(got / "ba" / "p01" / "ba_input_fixed_refined.npz") as zt:
        assert np.all(np.abs(zt["X3d"] - zs["X3d"]) <= 2e-3 * scale)
        np.testing.assert_allclose(zt["R"], zs["R"], atol=1e-6)
        np.testing.assert_allclose(zt["t"], zs["t"], atol=1e-5)
