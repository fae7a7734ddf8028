"""The ``train_pose`` CLI against skix's (CPU, YOLOv8-n at 64 px).

Two steps from one skix npz (``init_checkpoint``, which both CLIs read) on
a COCO keypoints fixture with augmentation: ``yolo_pose_000002.npz``
(parameters within the 2·lr a step that Adam's sign can part them by, 99 %
of them within lr/10; BatchNorm statistics within 1e-3 of their scale) and
``final_eval.txt`` (1e-3 relative). Nothing of the computation is patched:
skix's ``build_train_step`` is compiled at XLA's optimization level 0
(``_torch_parity.jit0``) in place of its ``jax.jit``, and so are the final
evaluation's forward (``jitapply.apply_model``) and decode (``detect``,
else run op by op).
"""

import numpy as np
import pytest

import jax

from _torch_parity import _CHEAP, jit0, port_variables

SIZE = 64


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from tests.test_yolo_pose import _write_coco_fixture

    root = tmp_path_factory.mktemp("coco_pose_cli")
    jp, _ = _write_coco_fixture(root, n_images=4, size=96)
    return root, jp


def test_cli_twin_matches_skix(coco, tmp_path, monkeypatch):
    from skix.config import load_config as skix_load_config
    from skix.models import yolo_pose as syolo
    from skix.pipelines import train_pose as skix_cli
    from skix.utils import jitapply
    from skix.pipelines.videopose3d import save_checkpoint as skix_save
    from skix_torch.pipelines import train_pose as port_cli

    from skix_torch.models.yolo_pose import YoloPose

    root, jp = coco
    v = port_variables(YoloPose(scale="n", version=8), 0)
    init = tmp_path / "init.npz"
    skix_save(str(init), v)
    steps, lr = 2, 1e-3
    body = dict(coco_json=str(jp), image_root=str(root), scale="n",
                image_size=SIZE, batch_size=2, max_objects=4, steps=steps,
                lr=lr, weight_decay=5e-4, grad_clip=10.0, augment=True,
                log_every=50, ckpt_every=500, final_eval=True, seed=0,
                init_checkpoint=str(init))
    cdir = tmp_path / "configs"
    cdir.mkdir()
    (cdir / "train_pose.yaml").write_text(
        f"paths:\n  checkpoint_dir: {tmp_path / 'ckpt_skix'}\n"
        + "".join(f"{k}: {str(x).lower() if isinstance(x, bool) else x}\n"
                  for k, x in body.items()))
    build = skix_cli.build_train_step
    monkeypatch.setattr(skix_cli, "build_train_step",
                        lambda m, o: jit0(build(m, o).__wrapped__))
    # the final evaluation's forward and decode, compiled once (_CHEAP):
    # skix's module-level apply at XLA's default level, detect op by op
    monkeypatch.setattr(jitapply, "apply_model", jax.jit(
        jitapply.apply_model.__wrapped__, static_argnums=(0, 1),
        compiler_options=_CHEAP))
    monkeypatch.setattr(syolo, "detect", jax.jit(
        syolo.detect, static_argnames=("top_k", "score_threshold"),
        compiler_options=_CHEAP))
    skix_cli.main.__wrapped__(skix_load_config("train_pose",
                                               config_dir=cdir))
    run = port_cli.main({**body, "device": "cpu", "paths": {
        "checkpoint_dir": str(tmp_path / "ckpt_port")}})

    name = f"yolo_pose_{steps:06d}.npz"
    with np.load(tmp_path / "ckpt_skix" / name) as z:
        sk = {k: z[k] for k in z.files}
    with np.load(tmp_path / "ckpt_port" / name) as z:
        pt = {k: z[k] for k in z.files}
    assert set(pt) == set(sk)
    for k in sk:
        assert pt[k].shape == sk[k].shape, k
        # Adam moves each parameter by at most ~lr a step; where the sign
        # of a rounding-level gradient differs the two part by up to 2·lr
        tol = (2 * steps * lr * 1.01 if k.startswith("params/")
               else 1e-3 * max(np.abs(sk[k]).max(), 1e-6))
        np.testing.assert_allclose(pt[k], sk[k], atol=tol, rtol=0,
                                   err_msg=k)
    diff = np.concatenate([np.abs(pt[k] - sk[k]).ravel() for k in sk
                           if k.startswith("params/")])
    assert (diff <= lr / 10).mean() >= 0.99
    want = float((tmp_path / "ckpt_skix" / "final_eval.txt").read_text())
    got = float((tmp_path / "ckpt_port" / "final_eval.txt").read_text())
    assert got == pytest.approx(want, rel=1e-3)
    assert run.final_error == got and len(run.steps) == steps
