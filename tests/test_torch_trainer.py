"""skix_torch.models.trainer and skix_torch.utils.checkpointing against
skix on the CPU: the Trainer's default Adam and AdamW, clipping that bites,
gradient accumulation and ``tx=`` over four micro-steps from the same
weights and batches; a resume in the middle of an accumulation; the
checkpoint cadence, ``keep_last`` and the validation hook; the unix-pattern
helpers selecting skix's names from the port's modules."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import port_variables, random_variables

from skix_torch.models import trainer as PT
from skix_torch.utils import checkpointing as PC


class MLP(torch.nn.Module):
    """Two Dense layers named as a flax ``dense_0``/``dense_1`` tree."""

    def __init__(self):
        super().__init__()
        self.dense_0 = torch.nn.Linear(4, 8)
        self.dense_1 = torch.nn.Linear(8, 3)

    def forward(self, x):
        return self.dense_1(torch.tanh(self.dense_0(x)))


def skix_loss(params, batch, rng):
    x, y = batch
    h = jnp.tanh(x @ params["dense_0"]["kernel"] + params["dense_0"]["bias"])
    out = h @ params["dense_1"]["kernel"] + params["dense_1"]["bias"]
    return jnp.mean((out - y) ** 2)


def port_loss(model, batch, generator):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def _setup(seed=0, n=4):
    model = MLP()
    variables = port_variables(model, seed)
    rng = np.random.default_rng(seed + 100)
    batches = [(rng.normal(size=(8, 4)).astype(np.float32),
                rng.normal(size=(8, 3)).astype(np.float32)) for _ in range(n)]
    return model, variables["params"], batches


def _torch_batches(batches):
    return [tuple(torch.as_tensor(a) for a in b) for b in batches]


def _jax_batches(batches):
    return [tuple(jnp.asarray(a) for a in b) for b in batches]


def _port_params(model):
    return PC.module_tree(model)["params"]


def _close(got, want, tol=1e-5):
    flat_g = dict(PC._flatten(got))
    flat_w = dict(PC._flatten(jax.device_get(want)))
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        np.testing.assert_allclose(np.asarray(flat_g[k]),
                                   np.asarray(flat_w[k]), atol=tol, rtol=0,
                                   err_msg=k)


def _sam3_style_tx(params, side, clip):
    """Pattern-scoped groups: dense_0 at another LR (a schedule), no decay
    on biases."""
    options = lambda R, S: {                                 # noqa: E731
        "lr": [R(3e-2), R(S(1e-1, 1, 0.5), ["dense_0/*"])],
        "weight_decay": [R(1e-2), R(0.0, ["*/bias"])]}
    if side == "skix":
        import optax

        from skix.models.optim import OptionRule, construct_optimizer

        def decay(v, s, d):
            return optax.exponential_decay(v, s, d, staircase=True)

        return construct_optimizer(params, options(OptionRule, decay),
                                   grad_clip_norm=clip)[0]
    from skix_torch.convert import flax_path
    from skix_torch.models.optim import (OptionRule, construct_optimizer,
                                         exponential_decay_schedule)

    named = [(flax_path(n, p.shape), p) for n, p in params.named_parameters()]
    return construct_optimizer(named, options(
        OptionRule, lambda v, s, d: exponential_decay_schedule(v, s, d)),
        clip)


CASES = {
    "adam": dict(lr=3e-2),
    "adamw": dict(lr=3e-2, weight_decay=0.1),
    "clip_bites": dict(lr=3e-2, weight_decay=0.1, grad_clip_norm=0.05),
    "accum2": dict(lr=3e-2, weight_decay=0.1, grad_accum_steps=2),
    "tx_accum2": dict(grad_accum_steps=2, grad_clip_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_matches_skix(case):
    """Four micro-steps, the parameters after each within 1e-5, the logged
    losses equal, the step counts equal."""
    from skix.models.trainer import Trainer, TrainerConfig

    kw = dict(CASES[case], max_steps=4, log_every=1, checkpoint_every=0)
    model, params, batches = _setup()
    s_tx = p_tx = None
    if case.startswith("tx"):
        s_tx = _sam3_style_tx(params, "skix", kw["grad_clip_norm"])
        p_tx = _sam3_style_tx(model, "port", kw["grad_clip_norm"])
    sk = Trainer(skix_loss, params, TrainerConfig(**kw), tx=s_tx)
    pt = PT.Trainer(port_loss, model, PT.TrainerConfig(**kw), tx=p_tx)
    assert PT.TrainerConfig() == PT.TrainerConfig(
        **{f: getattr(TrainerConfig(), f) for f in
           TrainerConfig.__dataclass_fields__})
    for i, (jb, tb) in enumerate(zip(_jax_batches(batches),
                                     _torch_batches(batches))):
        sk.state, s_loss = sk._step_fn(sk.state, jb, jax.random.PRNGKey(i))
        p_loss = pt._step(tb, None)
        np.testing.assert_allclose(float(p_loss), float(s_loss), atol=1e-5,
                                   rtol=0)
        _close(_port_params(model), sk.state.params)
    assert pt.state.step == int(sk.state.step) == 4


def test_fit_resume_in_the_middle_of_an_accumulation(tmp_path):
    """fit with accumulation 2 and a checkpoint every micro-step: a trainer
    rebuilt from fresh weights that resumes from micro-step 3 (the
    accumulator half full) and runs the last batch ends where the
    uninterrupted run ends, bit for bit, and where skix's ends; keep_last
    keeps the newest files with their sidecars; the validation hook runs on
    skix's cadence."""
    from skix.models.trainer import Trainer, TrainerConfig

    kw = dict(lr=3e-2, weight_decay=0.1, grad_accum_steps=2, max_steps=4,
              log_every=2, checkpoint_every=1, keep_last=2, val_every=2)
    model, params, batches = _setup(seed=3)
    tb, jb = _torch_batches(batches), _jax_batches(batches)
    pt = PT.Trainer(port_loss, model, PT.TrainerConfig(**kw),
                    ckpt_dir=tmp_path / "a")
    val = lambda m: float(sum(p.detach().square().sum()  # noqa: E731
                              for p in m.parameters()))
    hist = pt.fit(tb, val_fn=val)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    sk = Trainer(skix_loss, params, TrainerConfig(**dict(
        kw, checkpoint_every=0)))
    s_hist = sk.fit(jb, val_fn=lambda p: float(sum(
        jnp.sum(x ** 2) for x in jax.tree_util.tree_leaves(p))))
    _close(_port_params(model), sk.state.params)
    assert [s for s, _ in hist["loss"]] == [s for s, _ in s_hist["loss"]]
    np.testing.assert_allclose(hist["loss"], s_hist["loss"], atol=1e-5)
    np.testing.assert_allclose(hist["val"], s_hist["val"], atol=1e-4)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_00000003.meta.json", "step_00000003.npz",
        "step_00000004.meta.json", "step_00000004.npz"]

    # interrupted: three micro-steps, then a new trainer on fresh weights
    model2, _, _ = _setup(seed=3)
    first = PT.Trainer(port_loss, model2, PT.TrainerConfig(**dict(
        kw, max_steps=3)), ckpt_dir=tmp_path / "b")
    first.fit(tb[:3])
    assert first.optimizer.mini_step == 1
    model3, _, _ = _setup(seed=4)                     # other weights
    resumed = PT.Trainer(port_loss, model3, PT.TrainerConfig(**kw),
                         ckpt_dir=tmp_path / "b")
    resumed.fit(tb[3:])
    assert resumed.state.step == 4 and resumed.optimizer.gradient_step == 2
    for k, v in model3.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0)


def test_checkpoint_pattern_helpers_select_skix_names(tmp_path):
    """A port module's tree (the bridge's flax names) has skix's leaf names
    in skix's order, and every pattern helper selects the same leaves as
    skix's on skix's own tree; a save/restore round trip through the
    kernels equals skix's kernels on the tree in memory."""
    from skix.models.videopose3d import TemporalLifter as SkixLifter
    from skix.utils import checkpointing as SK
    from skix_torch.models.videopose3d import TemporalLifter

    port = TemporalLifter(filter_widths=(3, 3), channels=8)
    variables = port_variables(port, 5)
    shapes = random_variables(SkixLifter(filter_widths=(3, 3), channels=8),
                              np.random.default_rng(0),
                              jnp.zeros((1, 9, 17, 2)))
    tree = PC.module_tree(port)
    assert PC.tree_param_names(tree) == SK.tree_param_names(shapes)
    assert PC.tree_param_names(tree) == SK.tree_param_names(variables)

    patterns = [["params/bn_*"], ["*/kernel", "batch_stats/expand_bn/*"],
                ["params/conv_0_a/kernel"]]
    for pats in patterns:
        assert (PC.unix_pattern_to_parameter_names(
            pats, PC.tree_param_names(tree))
                == SK.unix_pattern_to_parameter_names(
            pats, SK.tree_param_names(variables)))
        for p_fn, s_fn in (
                (PC.filter_params_matching_unix_pattern,
                 SK.filter_params_matching_unix_pattern),
                (PC.exclude_params_matching_unix_pattern,
                 SK.exclude_params_matching_unix_pattern)):
            got, want = p_fn(pats, tree), s_fn(pats, variables)
            assert (PC.tree_param_names(got) == SK.tree_param_names(want))
    for mod in (PC, SK):
        with pytest.raises(AssertionError, match="don't match any param"):
            mod.unix_pattern_to_parameter_names(["params/nope*"],
                                                mod.tree_param_names(tree))
    assert PC.CkptIncludeKernel([])(tree) is tree
    assert PC.CkptExcludeKernel([])(tree) is tree

    # save → restore with kernels → merge onto another model's tree
    PC.save_pytree(tmp_path / "step_00000001", tree, {"step": 1})
    path, meta = PC.latest_checkpoint_path(tmp_path)
    assert meta == {"step": 1} and path.name == "step_00000001.npz"
    kernels = [PC.CkptIncludeKernel(["params/*"]),
               PC.CkptExcludeKernel(["params/shrink/*"])]
    other = TemporalLifter(filter_widths=(3, 3), channels=8)
    base = PC.module_tree(other)
    got = PC.merge_params(base, PC.load_checkpoint_and_apply_kernels(
        path, base, kernels))
    want = SK.merge_params(base, SK.CkptExcludeKernel(["params/shrink/*"])(
        SK.CkptIncludeKernel(["params/*"])(variables)))
    _close(got, want, tol=0)
    assert not PC.load_tree_into(other, got)
    _close(PC.module_tree(other), want, tol=0)
    restored = PC.restore_pytree(path, {"params": {"shrink": {
        "bias": torch.zeros(51, dtype=torch.float64)}}})
    assert restored["params"]["shrink"]["bias"].dtype == torch.float64
