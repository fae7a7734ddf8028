"""The ``sam3`` optimizer scheme of train_detector against skix's optax chain.

skix's ``build_optimizer`` (``optim.scheme: sam3``) builds one
``optax.multi_transform`` from fnmatch patterns over the flax paths; the
port resolves the same patterns over the paths that the weight bridge
gives its parameters into ``torch.optim.AdamW`` groups. Held here:

- every parameter's learning rate (at the first updates) and weight decay
  equal those of skix's group for its path: inverse-sqrt with warmup and
  cooldown, the backbone's own LR, BEiT layer decay with ``pos_embed``
  pinned, zero decay on biases and norm scales;
- three updates of a small module (a ViT-Det trunk under ``backbone`` and
  a head) from the same seeded gradients equal skix's jitted optax updates
  (float32 in other orders: 1e-6 against steps of ~1e-4).

One ``train_detector`` step in the sam3 configuration is held against
skix's in ``tests/test_torch_train_sam3.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_parity import random_variables

from skix_torch.convert import (flax_path, flax_to_state_dict, flatten_tree,
                                load_into, state_dict_to_flax)

SIZE, STEPS = 112, 4
OPTIM = {"scheme": "sam3", "lr_backbone": 1e-4, "warmup_steps": 1,
         "cooldown_steps": 2, "timescale": 2, "layer_decay": 0.8}
CFG = {"lr": 5e-4, "weight_decay": 0.05, "grad_clip": 1.0, "optim": OPTIM}
MODEL = dict(rope_style="sam3", pretrain_img_size=56, encoder_layers=1,
             decoder_layers=1)


@pytest.fixture(scope="module")
def tiny():
    from skix.tracking.sam3_detector import Sam3Detector

    m = Sam3Detector.tiny(**MODEL)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), random_variables(
        m, np.random.default_rng(0), jnp.zeros((1, SIZE, SIZE, 3))))
    return m, v


def _port_model(v):
    from skix_torch.tracking.sam3_detector import Sam3Detector

    model = Sam3Detector.tiny(null_prompt=True, **MODEL)
    load_into(model, flax_to_state_dict(v))
    return model


def test_param_groups_match_skix(tiny, monkeypatch):
    import skix.models.optim as skix_optim
    from skix.pipelines.train_detector import \
        build_optimizer as skix_build
    from skix_torch.pipelines.train_detector import build_optimizer

    _, v = tiny
    seen = []
    real = skix_optim.construct_optimizer

    def spy(*a, **kw):
        tx, groups = real(*a, **kw)
        seen.append(groups)
        return tx, groups

    monkeypatch.setattr(skix_optim, "construct_optimizer", spy)
    skix_build(CFG, v["params"], STEPS)
    want = {p: g for g in seen[0] for p in g["paths"]}

    opt = build_optimizer(CFG, _port_model(v), STEPS)
    got = {p: g for g in opt.groups for p in g["paths"]}
    assert set(got) == set(want) and len(opt.groups) == len(seen[0])
    scales = set()
    for path, w in want.items():
        g = got[path]
        for count in range(STEPS + 1):
            w_lr = float(w["lr"](count)) if callable(w["lr"]) else w["lr"]
            assert g["lr"](count) == pytest.approx(w_lr, rel=1e-6,
                                                   abs=1e-12), (path, count)
        assert float(g["weight_decay"]) == float(w["weight_decay"]), path
        scales.add(round(float(w["lr"](2)) / 1e-4, 6)
                   if path.startswith("backbone/") else None)
    # the trunk's layer decay: patch embed and blocks at their own scales
    assert len(scales) >= 4
    zero_wd = {p for p, g in got.items() if g["weight_decay"] == 0.0}
    assert zero_wd == {p for p in got if p.endswith(("/bias", "/scale"))}


def _small_module():
    """A ViT-Det trunk under ``backbone`` (the layer-decayed part, its
    pos_embed pinned) and a head with a bias and a norm: every rule of the
    scheme has parameters to act on."""
    from torch import nn

    from skix_torch.models.layers import Dense, LayerNorm
    from skix_torch.tracking.vitdet import ViTDetBackbone

    m = nn.Module()
    m.backbone = ViTDetBackbone(img_size=28, patch_size=14, embed_dim=16,
                                depth=2, num_heads=2, mlp_ratio=2.0,
                                window_size=2, global_att_blocks=(1,))
    m.head = Dense(16, 8)
    m.head_norm = LayerNorm(8)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in m.parameters():
            prm.normal_(0.0, 0.5, generator=gen)
    return m


def test_three_updates_match_skix():
    """Three updates from seeded gradients (clipped: their norm is above
    1), through skix's jitted optax chain and the port's optimizer."""
    from skix.pipelines.train_detector import \
        build_optimizer as skix_build
    from skix_torch.pipelines.train_detector import build_optimizer

    model = _small_module()
    params = state_dict_to_flax(model.state_dict())["params"]
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(
        np.float32), params) for _ in range(3)]
    tx = skix_build(CFG, params, STEPS)

    @jax.jit
    def run(p):
        state = tx.init(p)
        out = []
        for g in grads:
            upd, state = tx.update(g, state, p)
            p = optax.apply_updates(p, upd)
            out.append(p)
        return out

    want = run(params)
    opt = build_optimizer(CFG, model, STEPS)
    assert len(opt.groups) >= 5
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        for key, t in flax_to_state_dict(g).items():
            named[key].grad = t.clone()
        opt.step()
        got = flatten_tree(state_dict_to_flax(model.state_dict())["params"])
        for k, w in flatten_tree(want[step]).items():
            np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-6,
                                       rtol=0, err_msg=f"step {step} {k}")
    start = flatten_tree(params)
    assert all(np.abs(got[k] - start[k]).max() > 1e-5 for k in start)


def test_flax_paths_of_the_port_are_skix_paths(tiny):
    """The optimizer's patterns see skix's paths: the bridge's name map of
    every parameter of the port is a leaf path of skix's tree."""
    _, v = tiny
    want = {k[len("params/"):] for k in flatten_tree(v)}
    got = {flax_path(n, p.shape)
           for n, p in _port_model(v).named_parameters()}
    assert got == want
