"""The port's lifter training against skix's (CPU, a small lifter).

- One ``train_step`` (twice, across an epoch boundary of the exponential
  decay) from the same weights and batches, dropout at 0: the loss, the
  gradients, the updated parameters and the BatchNorm statistics (flax's
  update: the biased batch variance, momentum 0.9) within 1e-4 of their
  scale.
- The port's dropout draws its mask from the generator it is given.
- ``ChunkedGenerator`` gives skix's batches from the same seed, and its
  ``rng_state`` restores the shuffle.
- The ``train_lifter`` CLI twin: two epochs, then a resume to a third, on
  the same clips. The twin patches both sides to the same initial weights
  (``init_state`` on each side loads ``port_variables``' numbers) and
  builds both lifters with dropout 0 (``TemporalLifter`` patched), so that
  no random draw differs; it compares every epoch's parameters, BatchNorm
  statistics and Adam moments, and the meta files.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0, port_variables

from skix_torch.convert import flatten_tree, state_dict_to_flax

WIDTHS, CH, B = (3, 3), 32, 8


def _pair(dropout=0.0):
    """The port's strided lifter with ``port_variables``' weights, and
    skix's with the same variables."""
    from skix.models.videopose3d import TemporalLifter as SkixLifter
    from skix_torch.models.videopose3d import TemporalLifter

    port = TemporalLifter(filter_widths=WIDTHS, channels=CH, strided=True,
                          dropout=dropout)
    v = port_variables(port, 0)
    return port, SkixLifter(filter_widths=WIDTHS, channels=CH, strided=True,
                            dropout=dropout), v


def _batches(n, seed=1):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(B, 9, 17, 2)).astype(np.float32),
             r.normal(size=(B, 1, 17, 3)).astype(np.float32))
            for _ in range(n)]


def _close(got, want, tol=1e-4, what=""):
    for k, w in flatten_tree(want).items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, atol=tol * max(np.abs(w).max(),
                                                             1e-6),
                                   rtol=0, err_msg=f"{what}{k}")


def test_train_step_matches_skix():
    from skix.metrics.losses import mpjpe as skix_mpjpe
    from skix.models.train import TrainState as SkixState
    from skix.models.train import make_optimizer as skix_optimizer
    from skix.models.train import train_step as skix_step
    from skix_torch.models.train import TrainState, make_optimizer, train_step

    port, sm, v = _pair()
    tx = skix_optimizer(lr=1e-3, lr_decay=0.5, steps_per_epoch=1)
    state = SkixState(params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=tx.init(v["params"]), step=jnp.asarray(0))
    step = jit0(lambda st, x, y: skix_step(sm, tx, st, x, y,
                                           jax.random.PRNGKey(0)))

    def loss(p, stats, x, y):
        out, _ = sm.apply({"params": p, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
        return skix_mpjpe(out, y)

    grad = jit0(jax.grad(loss))
    ps = TrainState(port, make_optimizer(port.parameters(), lr=1e-3,
                                         lr_decay=0.5, steps_per_epoch=1), 0)
    for i, (x, y) in enumerate(_batches(2)):
        want_g = grad(state.params, state.batch_stats, x, y)
        state, want_loss = step(state, x, y)
        ps, got_loss = train_step(ps, torch.tensor(x), torch.tensor(y))
        assert abs(got_loss.item() - float(want_loss)) <= 1e-4 * abs(
            float(want_loss))
        got_g = flatten_tree(state_dict_to_flax(
            {n: p.grad for n, p in port.named_parameters()})["params"])
        _close(got_g, want_g, what=f"step {i} grad ")
        got = flatten_tree(state_dict_to_flax(port.state_dict()))
        _close({k[len("params/"):]: a for k, a in got.items()
                if k.startswith("params/")}, state.params,
               what=f"step {i} param ")
        _close({k[len("batch_stats/"):]: a for k, a in got.items()
                if k.startswith("batch_stats/")}, state.batch_stats,
               what=f"step {i} stats ")
    assert ps.step == 2 and ps.optimizer.count == int(state.step) == 2
    # the second update used the decayed rate (staircase at 1 step/epoch)
    assert ps.optimizer.opt.param_groups[0]["lr"] == pytest.approx(5e-4)


def test_dropout_draws_from_its_generator():
    """Training mode at rate 0.25: the same generator seed gives the same
    output, another seed another; a quarter of the units is dropped and the
    rest scaled by 4/3; evaluation mode draws nothing."""
    from skix_torch.models.videopose3d import TemporalLifter

    m = TemporalLifter(filter_widths=WIDTHS, channels=CH, strided=True,
                       dropout=0.25)
    x = torch.tensor(_batches(1)[0][0])
    m.train()
    outs = [m(x, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    h = torch.ones(64, 256)
    d = m._drop(h, torch.Generator().manual_seed(0))
    assert d.unique().tolist() == pytest.approx([0.0, 4 / 3])
    assert abs((d == 0).float().mean().item() - 0.25) < 0.01
    m.eval()
    assert torch.equal(m._drop(h, None), h)


def test_chunked_generator_matches_skix():
    from skix.models.generators import ChunkedGenerator as SkixGen
    from skix_torch.models.generators import ChunkedGenerator

    r = np.random.default_rng(2)
    p2 = [r.normal(size=(t, 17, 2)) for t in (20, 13)]
    p3 = [r.normal(size=(t, 17, 3)) for t in (20, 13)]
    a = ChunkedGenerator(p2, p3, 9, batch_size=5, seed=3)
    b = SkixGen(p2, p3, 9, batch_size=5, seed=3)
    assert len(a) == len(b)
    for _ in range(2):
        for (xa, ya), (xb, yb) in zip(a.epoch(), b.epoch()):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    saved = a.rng_state
    first = [x for x, _ in a.epoch()]
    a.rng_state = saved
    for x, y in zip(first, (x for x, _ in a.epoch())):
        np.testing.assert_array_equal(x, y)


def _write_clips(root):
    r = np.random.default_rng(4)
    root.mkdir()
    for i, T in enumerate((30, 22)):
        np.savez(root / f"clip{i}.npz",
                 pose_2d=r.normal(size=(T, 17, 2)).astype(np.float32),
                 pose_3d=r.normal(size=(T, 17, 3)).astype(np.float32))


def test_cli_twin_matches_skix(tmp_path, monkeypatch):
    import orbax.checkpoint as ocp

    import skix.models.train as skix_train_mod
    import skix.models.videopose3d as skix_vp
    import skix_torch.models.train as port_train_mod
    import skix_torch.models.videopose3d as port_vp
    from skix.config import load_config as skix_load_config
    from skix.pipelines import train_lifter as skix_cli
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.pipelines import train_lifter as port_cli

    data = tmp_path / "data"
    _write_clips(data)
    _, _, v = _pair()

    # both lifters without dropout, both starting from v
    class SkixLifter0(skix_vp.TemporalLifter):
        dropout: float = 0.0

    monkeypatch.setattr(skix_vp, "TemporalLifter", SkixLifter0)
    monkeypatch.setattr(port_vp, "TemporalLifter", functools.partial(
        port_vp.TemporalLifter, dropout=0.0))

    def skix_init(model, rng, optimizer=None, example_len=None):
        return skix_train_mod.TrainState(
            params=v["params"], batch_stats=v["batch_stats"],
            opt_state=optimizer.init(v["params"]), step=jnp.asarray(0))

    def port_init(model, seed=0, optimizer=None):
        with torch.no_grad():
            load_into(model, flax_to_state_dict(v))
        return port_train_mod.TrainState(model, optimizer, 0)

    monkeypatch.setattr(skix_train_mod, "init_state", skix_init)
    monkeypatch.setattr(port_train_mod, "init_state", port_init)

    def cfg_text(name, epochs, resume):
        return f"""
paths:
  data_root: {data}
  checkpoint_dir: {tmp_path / f'ckpt_{name}'}
filter_widths: [3, 3]
channels: {CH}
strided: true
batch_size: 16
epochs: {epochs}
lr: 0.001
lr_decay: 0.95
augment: true
resume: {str(resume).lower()}
seed: 0
"""

    def run(epochs, resume):
        cdir = tmp_path / f"configs_{epochs}"
        cdir.mkdir(exist_ok=True)
        (cdir / "train_lifter.yaml").write_text(cfg_text("skix", epochs,
                                                         resume))
        skix_cli.main.__wrapped__(skix_load_config("train_lifter",
                                                   config_dir=cdir))
        mapping = {"paths": {"data_root": str(data), "checkpoint_dir":
                             str(tmp_path / "ckpt_port")},
                   "filter_widths": [3, 3], "channels": CH, "strided": True,
                   "batch_size": 16, "epochs": epochs, "lr": 0.001,
                   "lr_decay": 0.95, "augment": True, "resume": resume,
                   "seed": 0, "device": "cpu"}
        return port_cli.main(mapping)

    first = run(2, False)
    assert [e["epoch"] for e in first.epochs] == [0, 1]
    resumed = run(3, True)
    assert [e["epoch"] for e in resumed.epochs] == [2]

    template = port_cli._param_tree(first.state.model, [
        p for p in first.state.model.parameters()])
    for epoch in range(3):
        meta_s = json.loads((tmp_path / "ckpt_skix" /
                             f"epoch_{epoch:04d}_meta.json").read_text())
        meta_p = json.loads((tmp_path / "ckpt_port" /
                             f"epoch_{epoch:04d}_meta.json").read_text())
        assert meta_p == meta_s
        with ocp.StandardCheckpointer() as ck:
            want = ck.restore((tmp_path / "ckpt_skix" /
                               f"epoch_{epoch:04d}").resolve())
        with np.load(tmp_path / "ckpt_port" / f"epoch_{epoch:04d}.npz") as z:
            got = {k: z[k] for k in z.files}
        assert int(got["step"]) == int(want["step"])
        _close({k[len("params/"):]: a for k, a in got.items()
                if k.startswith("params/")}, want["params"],
               what=f"epoch {epoch} param ")
        _close({k[len("batch_stats/"):]: a for k, a in got.items()
                if k.startswith("batch_stats/")}, want["batch_stats"],
               what=f"epoch {epoch} stats ")
        adam = want["opt_state"][0]
        assert int(got["opt_state/count"]) == int(adam["count"])
        for part in ("mu", "nu"):
            pre = f"opt_state/{part}/"
            _close({k[len(pre):]: a for k, a in got.items()
                    if k.startswith(pre)}, adam[part], tol=1e-3,
                   what=f"epoch {epoch} {part} ")
    assert set(flatten_tree(template)) == {
        k[len("params/"):] for k in got if k.startswith("params/")}
