"""The port's detector training against skix's, at the tiny preset.

- ``Sam3Detector.tiny()`` with the DAC one-to-many queries, per-layer aux
  scores and no text (the learned ``null_prompt``): every output at 1e-4;
- one step of ``train_detector``'s loss and optimizer from the same
  weights and batch: the greedy assignments exactly, the loss at 1e-5
  relative, every gradient leaf within 1e-4·max|g| + 1e-6, the updated
  parameters where |g| > 1e-5 (Adam moves a parameter by about lr·sign(g)
  at step 1, so where |g| is at rounding level the two may move it in
  opposite directions; the test reports how many elements that leaves
  out);
- the stage CLI twin of skix's ``TestDetectorTrainCLI`` at two steps from
  one skix checkpoint: the same batches, ``final_eval.json``, checkpoint
  keys and shapes, and the port's checkpoint read by skix's
  ``load_checkpoint`` gives the port's outputs;
- the stage CLI twin with ``loss: {exact_match: true, mask_points: 64}``
  (the auction in the detection loss, PointRend's sampled mask loss): two
  steps from one skix checkpoint, the PointRend candidates the same numbers
  on both sides (skix's ``jax.random.uniform`` and the port's
  ``matcher.uniform_points`` patched to draws that depend on the shape
  only, :func:`_same_points`);
- the inverse weight bridge's round trip.

skix runs on the CPU through its default path (XLA attention and its
autodiff); the port through the plain versions of K1–K5.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_parity import jit0, random_variables

from skix_torch.convert import (flax_to_state_dict, flatten_tree, load_into,
                                state_dict_to_flax)

SIZE = 112
LOSS = dict(cls="iabce", w_class=20.0, w_presence=20.0)
FIELDS = ["boxes_cxcywh", "scores", "mask_logits", "embeddings", "presence",
          "o2m_boxes", "o2m_scores", "o2m_mask_logits", "aux_boxes",
          "o2m_aux_boxes", "aux_scores", "o2m_aux_scores"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from tests.test_yolo_pose import _write_coco_fixture

    root = tmp_path_factory.mktemp("coco")
    jp, _ = _write_coco_fixture(root, n_images=5, size=96)
    return root, jp


@pytest.fixture(scope="module")
def skix_model():
    from skix.tracking.sam3_detector import Sam3Detector

    m = Sam3Detector.tiny()
    # init without a prompt, as skix's train_detector: null_prompt exists
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), random_variables(
        m, np.random.default_rng(0), jnp.zeros((1, SIZE, SIZE, 3))))
    assert "null_prompt" in v["params"]
    fwd = jit0(lambda p, x: m.apply({"params": p}, x, apply_dac=True,
                                       with_aux_scores=True))
    return m, v, fwd


@pytest.fixture(scope="module")
def batch(coco):
    from skix.data import CocoDataset, CocoLoader

    root, jp = coco
    loader = CocoLoader(CocoDataset(jp, image_root=root), batch_size=5,
                        image_size=SIZE, max_objects=4, mask_stride=4,
                        augment=True, seed=0)
    return next(iter(loader))


def _port_model(variables):
    from skix_torch.tracking.sam3_detector import Sam3Detector

    model = Sam3Detector.tiny(null_prompt=True)
    load_into(model, flax_to_state_dict(variables))
    return model


def _gt(boxes):
    b = np.asarray(boxes)
    return np.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
                     b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]],
                    -1).astype(np.float32) / SIZE


def _as_list(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.fixture(scope="module")
def outputs(skix_model, batch):
    _, v, fwd = skix_model
    imgs = np.asarray(batch["images"], np.float32) / 255.0
    want = fwd(v["params"], jnp.asarray(imgs))
    with torch.no_grad():
        got = _port_model(v)(torch.as_tensor(imgs), apply_dac=True,
                             with_aux_scores=True)
    return got, want


@pytest.mark.parametrize("field", FIELDS)
def test_tiny_detector_training_outputs_match_skix(outputs, field):
    """apply_dac=True, with_aux_scores=True, no text memory."""
    got, want = outputs
    g, w = _as_list(getattr(got, field)), _as_list(getattr(want, field))
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


@pytest.fixture(scope="module")
def step_pair(skix_model, batch):
    """One step of skix's train_detector (loss_fn, value_and_grad, the
    simple optax chain) and of the port's, from the same weights."""
    from skix.tracking.matcher import sam3_detection_loss, sam3_mask_loss
    from skix_torch.pipelines import train_detector as T
    from skix_torch.config import config_from_mapping

    m, v, _ = skix_model
    lr, steps, wd = 5e-4, 10, 1e-4

    gt = jnp.asarray(_gt(batch["boxes"]))

    def loss_fn(p, b):
        out = m.apply({"params": p}, b["images"].astype(jnp.float32) / 255.0,
                      apply_dac=True, with_aux_scores=True)
        det = sam3_detection_loss(out, gt, b["valid"], **LOSS)
        msk = sam3_mask_loss(out, gt, b["masks"], b["valid"])
        return det + msk

    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    loss, grads = jit0(jax.value_and_grad(loss_fn))(v["params"], jb)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.cosine_decay_schedule(lr, steps, alpha=0.05),
        weight_decay=wd))

    # the chain on all leaves as one flat vector: every transform is
    # elementwise but the global norm, which is the flat vector's norm, so
    # a few eager ops stand in for compiling the chain over ~800 leaves
    leaves, treedef = jax.tree_util.tree_flatten(v["params"])
    flat = [jnp.ravel(x) for x in (jnp.asarray(p) for p in leaves)]
    fp = jnp.concatenate(flat)
    fg = jnp.concatenate([jnp.ravel(g) for g in jax.tree_util.tree_leaves(
        grads)])
    upd, _ = tx.update(fg, tx.init(fp), fp)
    fnew = np.asarray(optax.apply_updates(fp, upd))
    cuts = np.cumsum([x.size for x in flat])[:-1]
    new = jax.tree_util.tree_unflatten(treedef, [
        x.reshape(np.shape(p)) for x, p in zip(np.split(fnew, cuts), leaves)])

    model = _port_model(v)
    cfg = config_from_mapping({"lr": lr, "weight_decay": wd, "grad_clip": 1.0,
                               "dac": True, "loss": {"cls": "iabce"}})
    opt = T.build_optimizer(cfg, model, steps)
    p_loss, _, _ = T.make_loss_fn(model, cfg, SIZE)(T.batch_to(batch, "cpu"))
    opt.zero_grad()
    p_loss.backward()
    # a parameter the loss does not reach has no grad in torch, a zero one
    # in jax (the neck's 0.5× level)
    p_grads = state_dict_to_flax(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()}, v)["params"]
    opt.step()
    p_new = state_dict_to_flax(model.state_dict(), v)["params"]
    return (float(loss), flatten_tree(grads), flatten_tree(new),
            p_loss.item(), flatten_tree(p_grads), flatten_tree(p_new))


def test_step_assignments_match_skix(outputs, batch):
    """The greedy matches of the first step, o2o (main and aux layers) and
    o2m (three repeats), are the same pairs: the losses compare like with
    like only then."""
    from skix.tracking.matcher import greedy_assign as skix_greedy
    from skix.tracking.matcher import matching_cost as skix_cost
    from skix_torch.tracking.matcher import greedy_assign, matching_cost

    got, want = outputs
    gt, valid = _gt(batch["boxes"]), batch["valid"]
    pairs = [(got.boxes_cxcywh, got.scores, want.boxes_cxcywh, want.scores, 1),
             (got.o2m_boxes, got.o2m_scores, want.o2m_boxes, want.o2m_scores,
              3)]
    pairs += [(gb, gs, wb, ws, 1) for gb, gs, wb, ws in zip(
        got.aux_boxes, got.aux_scores, want.aux_boxes, want.aux_scores)]
    for gb, gs, wb, ws, rep in pairs:
        a = greedy_assign(matching_cost(gb, torch.sigmoid(gs),
                                        torch.as_tensor(gt)),
                          torch.as_tensor(valid), repeats=rep)
        b = jit0(jax.vmap(lambda bx, sc, g, gv: skix_greedy(
            skix_cost(bx, jax.nn.sigmoid(sc), g), gv, repeats=rep)))(
            wb, ws, jnp.asarray(gt), jnp.asarray(valid))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (a >= 0).sum() > 0


def test_step_loss_and_grads_match_skix(step_pair):
    loss, grads, _, p_loss, p_grads, _ = step_pair
    assert abs(p_loss - loss) <= 1e-5 * abs(loss)
    assert set(p_grads) == set(grads)
    for k, g in grads.items():
        g = np.asarray(g)
        tol = 1e-4 * np.abs(g).max() + 1e-6
        np.testing.assert_allclose(p_grads[k], g, atol=tol, rtol=0,
                                   err_msg=k)


def test_step_updated_params_match_skix(step_pair):
    """After one step, where |g_skix| > 1e-5. Adam's first step moves a
    parameter by lr·ĝ/(|ĝ| + 1e-8), ĝ the clipped gradient: about ±lr, so a
    wrong sign parts the two by ~2·lr. Clipping divides by the global norm
    (≈ 790 here), which brings |g| ≈ 1e-5 down to eps, where the step is
    not yet saturated and rounding-level gradient differences move it by
    up to 4e-6 (measured on the CPU): the limit is lr/50."""
    _, grads, new, _, _, p_new = step_pair
    lr = 5e-4
    below = total = leaves_below = 0
    for k, w in new.items():
        g = np.abs(np.asarray(grads[k]))
        sel = g > 1e-5
        below += int((~sel).sum())
        total += g.size
        leaves_below += int(not sel.any())
        np.testing.assert_allclose(p_new[k][sel], np.asarray(w)[sel],
                                   atol=lr / 50, rtol=0, err_msg=k)
    print(f"not compared: {below} of {total} parameter elements, "
          f"{leaves_below} of {len(new)} leaves wholly, have |g| <= 1e-5")
    assert below < total


def test_cli_twin_matches_skix(coco, skix_model, tmp_path):
    """skix's train_detector and the port's, two steps from one skix
    checkpoint on the COCO fixture with augmentation: the same batches,
    final_eval.json, checkpoint keys and shapes; the port's checkpoint
    loads in skix's load_checkpoint and gives the port's outputs."""
    from skix.config import load_config as skix_load_config
    from skix.data import CocoDataset as SkixDataset
    from skix.data import CocoLoader as SkixLoader
    from skix.pipelines import train_detector as skix_train
    from skix.pipelines.videopose3d import load_checkpoint as skix_load
    from skix.pipelines.videopose3d import save_checkpoint as skix_save
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.pipelines import train_detector as port_train

    root, jp = coco
    m, v, fwd = skix_model
    init = tmp_path / "init.npz"
    skix_save(str(init), v)
    lr, steps = 5e-4, 2

    def write_cfg(name):
        cdir = tmp_path / f"configs_{name}"
        cdir.mkdir()
        (cdir / "train_detector.yaml").write_text(f"""
paths:
  checkpoint_dir: {tmp_path / f'ckpt_{name}'}
coco_json: {jp}
image_root: {root}
preset: tiny
batch_size: 5
max_objects: 4
steps: {steps}
lr: {lr}
grad_clip: 1.0
dac: true
mask_weight: 1.0
loss:
  cls: iabce
augment: true
eval_ap: true
log_every: 50
ckpt_every: 500
seed: 0
init_checkpoint: {init}
""")
        return cdir

    skix_train.main.__wrapped__(skix_load_config(
        "train_detector", config_dir=write_cfg("skix")))
    run = port_train.main([f"--config-dir={write_cfg('port')}", "device=cpu"])

    # the same batches from the same seed, augmentation on
    a = CocoLoader(CocoDataset(jp, image_root=root), batch_size=5,
                   image_size=SIZE, max_objects=4, seed=0)
    b = SkixLoader(SkixDataset(jp, image_root=root), batch_size=5,
                   image_size=SIZE, max_objects=4, seed=0)
    for _, x, y in zip(range(steps), a, b):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)

    want = json.loads((tmp_path / "ckpt_skix" / "final_eval.json").read_text())
    got = json.loads((tmp_path / "ckpt_port" / "final_eval.json").read_text())
    assert set(got) == set(want)
    assert abs(got["final_loss"] - want["final_loss"]) <= \
        1e-4 * abs(want["final_loss"])
    assert got["ap_before"] == pytest.approx(want["ap_before"], abs=1e-9)
    assert got["ap_after"] == pytest.approx(want["ap_after"], abs=1e-9)

    name = f"sam3_detector_{steps:06d}.npz"
    with np.load(tmp_path / "ckpt_skix" / name) as z:
        sk = {k: z[k] for k in z.files}
    with np.load(tmp_path / "ckpt_port" / name) as z:
        pt = {k: z[k] for k in z.files}
    assert set(pt) == set(sk)
    assert all(pt[k].shape == sk[k].shape and pt[k].dtype == sk[k].dtype
               for k in sk)
    # Adam moves each parameter by at most ~lr per step; where the sign of
    # a rounding-level gradient differs the two part by up to 2·lr a step
    diff = np.concatenate([np.abs(pt[k] - sk[k]).ravel() for k in sk])
    assert diff.max() <= 2 * steps * lr * 1.01
    assert (diff <= 1e-6).mean() >= 0.99

    # the port's checkpoint through skix's reader, skix's model (five
    # images: the batch the file's jitted forward was compiled for)
    params = skix_load(str(tmp_path / "ckpt_port" / name))["params"]
    imgs = np.random.default_rng(9).random((5, SIZE, SIZE, 3)).astype(
        np.float32)
    want_out = fwd(params, jnp.asarray(imgs))
    with torch.no_grad():
        got_out = run.model(torch.as_tensor(imgs), apply_dac=True,
                            with_aux_scores=True)
    for field in ("boxes_cxcywh", "scores", "mask_logits", "o2m_scores"):
        np.testing.assert_allclose(getattr(got_out, field).numpy(),
                                   np.asarray(getattr(want_out, field)),
                                   atol=1e-4, rtol=0, err_msg=field)


def test_inverse_bridge_round_trip(skix_model):
    """flax → state_dict → flax gives back every leaf of skix's tree: the
    same keys, shapes, dtypes and values."""
    _, v, _ = skix_model
    back = state_dict_to_flax(_port_model(v).state_dict(), v)
    want, got = flatten_tree(v), flatten_tree(back)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == np.shape(w) and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


@contextlib.contextmanager
def _same_points():
    """skix's ``jax.random.uniform`` (for the (Q, P, 2) point draws) and the
    port's ``uniform_points`` give the same numbers, which depend on the
    draw's last three axes only."""
    from skix_torch.tracking import matcher as TM

    orig_j, orig_t = jax.random.uniform, TM.uniform_points

    def draws(shape):
        seed = int(np.prod(shape[-3:]))
        return np.random.default_rng(seed).random(shape[-3:]).astype(
            np.float32)

    def fake_j(key, shape=(), *a, **k):
        if len(shape) == 3 and shape[-1] == 2:
            return jnp.asarray(draws(shape))
        return orig_j(key, shape, *a, **k)

    def fake_t(generator, shape, device):
        return torch.as_tensor(draws(shape)).expand(shape).to(device)

    jax.random.uniform, TM.uniform_points = fake_j, fake_t
    try:
        yield
    finally:
        jax.random.uniform, TM.uniform_points = orig_j, orig_t


def test_port_refuses_what_is_not_ported(coco, skix_model, tmp_path):
    """``loss.exact_match`` and ``loss.mask_points`` run in the port as in
    skix: the CLIs' two steps from one checkpoint give the same final loss
    (1e-4 relative) and checkpoints within Adam's 2·lr a step, 99 % of the
    parameters within 1e-6. The name is the one this test had while the
    port refused both options."""
    from skix.config import load_config as skix_load_config
    from skix.pipelines import train_detector as skix_train
    from skix.pipelines.videopose3d import save_checkpoint as skix_save
    from skix_torch.pipelines import train_detector as port_train

    root, jp = coco
    _, v, _ = skix_model
    init = tmp_path / "init.npz"
    skix_save(str(init), v)
    lr, steps = 5e-4, 2
    body = {"coco_json": str(jp), "image_root": str(root), "preset": "tiny",
            "batch_size": 5, "max_objects": 4, "steps": steps, "lr": lr,
            "grad_clip": 1.0, "dac": True, "mask_weight": 1.0,
            "augment": True, "eval_ap": False, "seed": 0,
            "init_checkpoint": str(init)}
    cdir = tmp_path / "configs"
    cdir.mkdir()
    (cdir / "train_detector.yaml").write_text(
        f"paths:\n  checkpoint_dir: {tmp_path / 'ckpt_skix'}\n"
        "loss:\n  cls: iabce\n  exact_match: true\n  mask_points: 64\n"
        + "".join(f"{k}: {str(x).lower() if isinstance(x, bool) else x}\n"
                  for k, x in body.items()))
    with _same_points():
        skix_train.main.__wrapped__(skix_load_config("train_detector",
                                                     config_dir=cdir))
        port_train.main({**body, "device": "cpu", "loss": {
            "cls": "iabce", "exact_match": True, "mask_points": 64},
            "paths": {"checkpoint_dir": str(tmp_path / "ckpt_port")}})
    want = json.loads((tmp_path / "ckpt_skix" / "final_eval.json").read_text())
    got = json.loads((tmp_path / "ckpt_port" / "final_eval.json").read_text())
    assert set(got) == set(want) == {"final_loss"}
    assert abs(got["final_loss"] - want["final_loss"]) <= \
        1e-4 * abs(want["final_loss"])
    name = f"sam3_detector_{steps:06d}.npz"
    with np.load(tmp_path / "ckpt_skix" / name) as z:
        sk = {k: z[k] for k in z.files}
    with np.load(tmp_path / "ckpt_port" / name) as z:
        pt = {k: z[k] for k in z.files}
    assert set(pt) == set(sk)
    diff = np.concatenate([np.abs(pt[k] - sk[k]).ravel() for k in sk])
    assert diff.max() <= 2 * steps * lr * 1.01
    assert (diff <= 1e-6).mean() >= 0.99


def test_build_detector_defaults_to_the_card():
    """``build_detector`` takes its default device from ``resolve_device``
    (cuda): on a machine without a card it raises instead of building on
    the CPU; asked for the CPU, it builds there."""
    from skix_torch.pipelines.train_detector import build_detector

    model = build_detector({"preset": "tiny"}, "cpu")
    assert next(model.parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        assert next(build_detector({"preset": "tiny"}).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_detector({"preset": "tiny"})
