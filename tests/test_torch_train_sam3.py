"""One ``train_detector`` step in the reference SAM3 configuration against
skix's: ``model: {rope_style: sam3}`` (the interleaved rope through the
plain K2/K5 and K1/K3/K4) and ``optim.scheme: sam3``, from the same weights
and batch, with no warmup so that the first step moves the weights.

As ``tests/test_torch_train_detector.py``: the loss at 1e-5 relative and
each gradient leaf within 1e-4·max|g| + 1e-6. A leaf whose skix gradient
moves by more than a tenth of its largest element when the batch is
reversed (the same loss in exact arithmetic) is left out of the gradient
check: its exact gradient is 0 and both packages return rounding noise (up
to ~3e-6 here). These are the softmax-invariant biases, the box-RPB output
biases and the attention key biases, each adding one constant to every
logit of a row; they hold under 1 % of the gradient's elements. The
step's optimizer is the ``sam3`` scheme's (its groups); its updates are held
against skix's optax chain in ``tests/test_torch_optim_sam3.py`` (skix's
jitted update of this tree would add ~4 s of compilation here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0, random_variables

from skix.data import CocoDataset, CocoLoader
from skix.tracking.matcher import sam3_detection_loss, sam3_mask_loss
from skix.tracking.sam3_detector import Sam3Detector
from skix_torch.config import config_from_mapping
from skix_torch.convert import (flax_to_state_dict, flatten_tree, load_into,
                                state_dict_to_flax)
from skix_torch.pipelines import train_detector as T
from skix_torch.tracking.sam3_detector import Sam3Detector as Port

SIZE, STEPS = 112, 4
OPTIM = {"scheme": "sam3", "lr_backbone": 1e-4, "warmup_steps": 0,
         "cooldown_steps": 2, "timescale": 2, "layer_decay": 0.8}
# no DAC queries: the one-to-many half is checked at the default scheme in
# tests/test_torch_train_detector.py; here the rope and the scheme change
CFG = {"lr": 5e-4, "weight_decay": 0.05, "grad_clip": 1.0, "optim": OPTIM,
       "dac": False, "loss": {"cls": "iabce"}}
MODEL = dict(rope_style="sam3", pretrain_img_size=56, encoder_layers=1,
             decoder_layers=1)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from tests.test_yolo_pose import _write_coco_fixture

    root = tmp_path_factory.mktemp("coco_sam3")
    jp, _ = _write_coco_fixture(root, n_images=2, size=96)
    return root, jp


def test_train_step_sam3_matches_skix(coco):
    m = Sam3Detector.tiny(**MODEL)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), random_variables(
        m, np.random.default_rng(0), jnp.zeros((1, SIZE, SIZE, 3))))
    root, jp = coco
    batch = next(iter(CocoLoader(CocoDataset(jp, image_root=root),
                                 batch_size=2, image_size=SIZE,
                                 max_objects=4, mask_stride=4, augment=True,
                                 seed=0)))
    cfg = CFG

    def loss_fn(p, bt):
        b = bt["boxes"]
        gt = jnp.stack([(b[..., 0] + b[..., 2]) / 2,
                        (b[..., 1] + b[..., 3]) / 2,
                        b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1) / SIZE
        out = m.apply({"params": p}, bt["images"].astype(jnp.float32) / 255.0,
                      apply_dac=False, with_aux_scores=True)
        det = sam3_detection_loss(out, gt, bt["valid"], cls="iabce",
                                  w_class=20.0, w_presence=20.0)
        return det + sam3_mask_loss(out, gt, bt["masks"], bt["valid"])

    value_and_grad = jit0(jax.value_and_grad(loss_fn))
    loss, grads = value_and_grad(
        v["params"], {k: jnp.asarray(x) for k, x in batch.items()})
    _, rev = value_and_grad(   # the batch reversed: the same exact loss
        v["params"], {k: jnp.asarray(x[::-1]) for k, x in batch.items()})
    model = Port.tiny(null_prompt=True, **MODEL)
    load_into(model, flax_to_state_dict(v))
    pcfg = config_from_mapping(cfg)
    opt = T.build_optimizer(pcfg, model, STEPS)
    p_loss, _, _ = T.make_loss_fn(model, pcfg, SIZE)(T.batch_to(batch, "cpu"))
    opt.zero_grad()
    p_loss.backward()
    p_grads = flatten_tree(state_dict_to_flax(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()}, v))
    assert len(opt.groups) > 2              # the sam3 scheme's groups
    opt.step()
    p_new = flatten_tree(state_dict_to_flax(model.state_dict(), v))

    assert abs(p_loss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    want, want_rev = (flatten_tree({"params": g}) for g in (grads, rev))
    noise = {k for k, g in want.items()
             if np.abs(np.asarray(want_rev[k]) - g).max()
             > 0.1 * np.abs(np.asarray(g)).max()}
    assert {"params/decoder/box_rpb/embed_x_fc2/bias",
            "params/decoder/box_rpb/embed_y_fc2/bias"} <= noise
    assert (sum(np.size(want[k]) for k in noise)
            < 0.01 * sum(np.size(g) for g in want.values()))
    for k, g in want.items():
        g = np.asarray(g)
        if k not in noise:
            np.testing.assert_allclose(p_grads[k], g,
                                       atol=1e-4 * np.abs(g).max() + 1e-6,
                                       rtol=0, err_msg=k)
    start = flatten_tree(v)
    reached = [k for k, g in flatten_tree({"params": grads}).items()
               if np.abs(np.asarray(g)).max() > 1e-5]
    assert len(reached) > len(start) // 2
    assert all(np.abs(p_new[k] - start[k]).max() > 0 for k in reached)
