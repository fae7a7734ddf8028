"""The port's YOLO pose training against skix's (CPU, YOLOv8-n).

- ``pose_detection_loss`` on the same raw predictions: the task-aligned
  assignment's picks exactly, every term at 1e-5 relative.
- One training step from the same weights and batch of four 96 px images
  (the training-mode forward with batch statistics, the loss, global-norm
  clipping and AdamW with the cosine rate): the loss, the gradients, the
  updated parameters and the BatchNorm statistics (flax's momentum 0.97)
  within 1e-4 of their scale. (At 64 px and two images the deepest
  BatchNorm normalizes 8 values and float32 rounding alone moves the
  port's gradients by 1.8e-4 of their scale against its float64 run.)

The CLI twin is ``tests/test_torch_train_pose_cli.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0, port_variables

from skix_torch.convert import flatten_tree, state_dict_to_flax

SIZE, B = 96, 4


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from tests.test_yolo_pose import _write_coco_fixture

    root = tmp_path_factory.mktemp("coco_pose")
    jp, _ = _write_coco_fixture(root, n_images=4, size=96)
    return root, jp


@pytest.fixture(scope="module")
def pair():
    from skix.models.yolo_pose import YoloPose as SkixYolo
    from skix_torch.models.yolo_pose import YoloPose

    port = YoloPose(scale="n", version=8)
    v = port_variables(port, 0)
    return port, SkixYolo(scale="n", version=8), v


@pytest.fixture(scope="module")
def batch(coco):
    from skix_torch.data import CocoDataset, CocoLoader

    root, jp = coco
    return next(iter(CocoLoader(CocoDataset(jp, image_root=root),
                                batch_size=B, image_size=SIZE,
                                max_objects=4, augment=True, seed=0)))


def _scaled_close(got, want, tol, what=""):
    for k, w in flatten_tree(want).items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, atol=tol * max(np.abs(w).max(),
                                                             1e-6),
                                   rtol=0, err_msg=f"{what}{k}")


def _sub(flat, prefix):
    return {k[len(prefix):]: a for k, a in flat.items()
            if k.startswith(prefix)}


def test_pose_loss_matches_skix(pair, batch):
    """Random raw heads (the model's anchors) and the fixture's gt."""
    from skix.models import yolo_loss as SL
    from skix.models.yolo_pose import RawPredictions as SkixRaw
    from skix_torch.models import yolo_loss as TL
    from skix_torch.models.yolo_pose import RawPredictions

    port, _, _ = pair
    with torch.no_grad():
        port.eval()
        raw = port(torch.zeros(B, SIZE, SIZE, 3))
    r = np.random.default_rng(3)
    fields = {"box_dist": r.normal(size=raw.box_dist.shape),
              "cls_logits": r.normal(0, 2, raw.cls_logits.shape),
              "kpt_raw": r.normal(size=raw.kpt_raw.shape)}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields.update(anchors=raw.anchors.numpy(), strides=raw.strides.numpy())
    gt = [batch[k] for k in ("boxes", "keypoints", "valid", "cls")]
    want_a = jit0(lambda f, b, c, v: SL.task_aligned_assign(
        SkixRaw(**f), b, c, v))(fields, gt[0], gt[3], gt[2])
    want_t, want_aux = jit0(lambda f, b, k, v, c: SL.pose_detection_loss(
        SkixRaw(**f), b, k, v, gt_cls=c))(fields, *gt)
    traw = RawPredictions(**{k: torch.tensor(v) for k, v in fields.items()})
    tgt = [torch.tensor(x) for x in gt]
    got_a = TL.task_aligned_assign(traw, tgt[0], tgt[3], tgt[2])
    fg = np.asarray(want_a[1])
    assert fg.sum() > 0
    np.testing.assert_array_equal(got_a[1].numpy(), fg)
    np.testing.assert_array_equal(got_a[0].numpy()[fg],
                                  np.asarray(want_a[0])[fg])
    np.testing.assert_allclose(got_a[2].numpy(), np.asarray(want_a[2]),
                               atol=1e-6, rtol=1e-5)
    got_t, got_aux = TL.pose_detection_loss(traw, *tgt[:3], gt_cls=tgt[3])
    assert abs(got_t.item() - float(want_t)) <= 1e-5 * abs(float(want_t))
    for k, w in want_aux.items():
        assert got_aux[k].item() == pytest.approx(float(w), rel=1e-5,
                                                  abs=1e-7), k


def test_train_step_matches_skix(pair, batch):
    import optax

    from skix.models.yolo_loss import pose_detection_loss
    from skix_torch.models.optim import ClippedAdamW, cosine_decay_schedule
    from skix_torch.pipelines import train_pose as T

    port, sm, v = pair
    lr, steps, wd, clip = 1e-3, 10, 5e-4, 10.0

    def loss_fn(params, stats, b):
        raw, upd = sm.apply({"params": params, "batch_stats": stats},
                            b["images"].astype(jnp.float32) / 255.0,
                            train=True, mutable=["batch_stats"])
        total, aux = pose_detection_loss(raw, b["boxes"], b["keypoints"],
                                         b["valid"], gt_cls=b["cls"])
        return total, upd["batch_stats"]

    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    (loss, stats), grads = jit0(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], jb)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(
        optax.cosine_decay_schedule(lr, steps, alpha=0.05), weight_decay=wd))
    # the chain on all leaves as one flat vector (elementwise but the
    # global norm, which is the flat vector's)
    leaves, treedef = jax.tree_util.tree_flatten(v["params"])
    flat = [np.ravel(p) for p in leaves]
    fp = jnp.concatenate(flat)
    fg = jnp.concatenate([jnp.ravel(g) for g in
                          jax.tree_util.tree_leaves(grads)])
    upd, _ = tx.update(fg, tx.init(fp), fp)
    fnew = np.asarray(optax.apply_updates(fp, upd))
    cuts = np.cumsum([x.size for x in flat])[:-1]
    new = jax.tree_util.tree_unflatten(treedef, [
        x.reshape(np.shape(p)) for x, p in zip(np.split(fnew, cuts), leaves)])

    opt = ClippedAdamW([{"params": list(port.parameters()),
                         "lr": cosine_decay_schedule(lr, steps, 0.05),
                         "weight_decay": wd}], clip)
    got_loss, _ = T.build_train_step(port, opt)(
        {k: torch.as_tensor(x) for k, x in batch.items()})
    assert abs(got_loss.item() - float(loss)) <= 1e-4 * abs(float(loss))
    # the gradient before clipping: the port's grads were clipped in place
    norm = float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                             for g in jax.tree_util.tree_leaves(grads))))
    unclip = max(norm / clip, 1.0)
    got_g = flatten_tree(state_dict_to_flax(
        {n: p.grad * unclip for n, p in port.named_parameters()})["params"])
    _scaled_close(got_g, grads, 1e-4, "grad ")
    got = flatten_tree(state_dict_to_flax(port.state_dict()))
    _scaled_close(_sub(got, "batch_stats/"), stats, 1e-4, "stats ")
    # Adam's first step moves a parameter by about ±lr·sign(g): compare
    # where |g| is above the rounding level of its leaf
    for k, w in flatten_tree(new).items():
        g = np.abs(np.asarray(flatten_tree(grads)[k]))
        sel = g > 1e-3 * g.max()
        np.testing.assert_allclose(got["params/" + k][sel],
                                   np.asarray(w)[sel], atol=lr / 50, rtol=0,
                                   err_msg=k)
