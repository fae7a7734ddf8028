"""skix_torch's temporal lifter against skix, float32 on the CPU: the
module on skix's variables (BatchNorm statistics included) through the
weight bridge, the causal and strided variants, flip-augmented
full-sequence inference, ``fold_batchnorm``, the reference-layout
converter, the checkpoint readers, and the committed
``tests/fixtures/lifter_tiny.npz``: held-out MPJPE < 50 mm and equal to
skix's within 1e-5 m."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0, random_variables
from skix.geometry.camera import normalize_screen_coordinates
from skix.models import videopose3d as svp
from skix.pipelines.videopose3d import load_checkpoint as skix_load_checkpoint
from skix.pipelines.videopose3d import save_checkpoint as skix_save_checkpoint
from skix_torch.convert import flax_to_state_dict, load_into, state_dict_to_flax
from skix_torch.models import videopose3d as tvp
from skix_torch.pipelines.videopose3d import load_checkpoint

FIXTURE = Path(__file__).parent / "fixtures" / "lifter_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
WIDTHS, CH = (3, 3), 64


def _variables(module, rng, x):
    """``random_variables`` with BatchNorm statistics that a trained model
    could hold (positive variances)."""
    v = random_variables(module, rng, x, train=False)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    for name, st in v["batch_stats"].items():
        st["mean"] = (rng.normal(size=st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    return v


def _port(variables, **kw):
    m = tvp.TemporalLifter(filter_widths=WIDTHS, channels=CH, **kw)
    load_into(m, flax_to_state_dict(variables))
    return m.eval()


@pytest.fixture(scope="module")
def lifter():
    rng = np.random.default_rng(0)
    model = svp.TemporalLifter(filter_widths=WIDTHS, channels=CH)
    x = rng.normal(size=(2, model.rf + 6, 17, 2)).astype(np.float32)
    variables = _variables(model, rng, x)
    apply = jit0(lambda v, xx: model.apply(v, xx, train=False))
    return model, variables, apply, x


def test_forward_matches_skix(lifter):
    model, variables, apply, x = lifter
    want = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(variables)(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 6 + 1, 17, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("causal,strided", [(True, False), (False, True),
                                            (True, True)])
def test_causal_and_strided_variants_match_skix(lifter, causal, strided):
    _, variables, _, x = lifter
    model = svp.TemporalLifter(filter_widths=WIDTHS, channels=CH,
                               causal=causal, strided=strided)
    xin = x[:, :model.rf] if strided else x
    want = np.asarray(model.apply(variables, jnp.asarray(xin), train=False))
    with torch.no_grad():
        got = _port(variables, causal=causal, strided=strided)(
            torch.tensor(xin)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_infer_sequence_with_flip_matches_skix(lifter):
    model, variables, _, _ = lifter
    kp = np.random.default_rng(1).normal(size=(30, 17, 2)).astype(np.float32)
    for flip in (True, False):
        want = np.asarray(svp.infer_sequence(model, variables, jnp.asarray(kp),
                                             flip_augment=flip))
        got = tvp.infer_sequence(_port(variables), torch.tensor(kp),
                                 flip_augment=flip).numpy()
        assert got.shape == (30, 17, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(
        tvp.pad_for_inference(torch.tensor(kp), 9, 1).numpy(),
        np.asarray(svp.pad_for_inference(jnp.asarray(kp), 9, 1)))


def test_fold_batchnorm_matches_skix(lifter):
    model, variables, apply, x = lifter
    folded = svp.fold_batchnorm(variables)
    sd = flax_to_state_dict(variables)
    got_sd = tvp.fold_batchnorm(sd)
    want_sd = flax_to_state_dict(folded)
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   atol=1e-6, err_msg=k)
    m = tvp.TemporalLifter(filter_widths=WIDTHS, channels=CH)
    load_into(m, got_sd)
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(torch.tensor(x)).numpy(),
                                   np.asarray(apply(folded, jnp.asarray(x))),
                                   atol=1e-4)


def test_reference_state_dict_converts_as_skix_does(lifter):
    """A state dict in the reference VideoPose3D ``model_pos`` layout
    (``layers_conv.{2i,2i+1}``, ``layers_bn.{2i,2i+1}``) → skix's converter
    and the port's give the same module; the torch ``.bin`` branch of the
    port's checkpoint reader takes it too."""
    _, variables, apply, x = lifter
    port_sd = _port(variables).state_dict()
    names = {"expand_conv": "expand_conv", "expand_bn": "expand_bn",
             "shrink": "shrink"}
    for i in range(len(WIDTHS) - 1):
        names.update({f"conv_{i}_a": f"layers_conv.{2 * i}",
                      f"conv_{i}_b": f"layers_conv.{2 * i + 1}",
                      f"bn_{i}_a": f"layers_bn.{2 * i}",
                      f"bn_{i}_b": f"layers_bn.{2 * i + 1}"})
    ref = {f"{names[k.rpartition('.')[0]]}.{k.rpartition('.')[2]}": v
           for k, v in port_sd.items()}
    want = svp.convert_reference_state_dict(ref, filter_widths=WIDTHS)
    m = tvp.TemporalLifter(filter_widths=WIDTHS, channels=CH)
    load_into(m, tvp.convert_reference_state_dict(ref, filter_widths=WIDTHS))
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(torch.tensor(x)).numpy(),
                                   np.asarray(apply(want, jnp.asarray(x))),
                                   atol=1e-4)


def test_checkpoints_bridge_both_ways(lifter, tmp_path):
    """skix's ``save_checkpoint`` npz (params + batch_stats) loads into the
    port's module; a ``.bin`` of the reference layout reads as skix's
    variables; the inverse bridge gives skix's tree back."""
    _, variables, apply, x = lifter
    skix_save_checkpoint(str(tmp_path / "lifter.npz"), variables)
    m = tvp.TemporalLifter(filter_widths=WIDTHS, channels=CH)
    load_into(m, flax_to_state_dict(load_checkpoint(tmp_path / "lifter.npz")))
    want = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(torch.tensor(x)).numpy(), want,
                                   atol=1e-4)
    back = state_dict_to_flax(m.state_dict())
    for col in ("params", "batch_stats"):
        flat_b = jax.tree_util.tree_leaves_with_path(back[col])
        flat_v = dict(jax.tree_util.tree_leaves_with_path(variables[col]))
        assert len(flat_b) == len(flat_v)
        for path, leaf in flat_b:
            np.testing.assert_array_equal(leaf, flat_v[path], err_msg=str(path))

    ref = {"model_pos": {k.replace("conv_0_a", "layers_conv.0")
                         .replace("conv_0_b", "layers_conv.1")
                         .replace("bn_0_a", "layers_bn.0")
                         .replace("bn_0_b", "layers_bn.1"): v
                         for k, v in m.state_dict().items()}}
    torch.save(ref, tmp_path / "ref.bin")
    from_bin = load_checkpoint(tmp_path / "ref.bin")
    m2 = tvp.TemporalLifter(filter_widths=WIDTHS, channels=CH)
    load_into(m2, flax_to_state_dict(from_bin))
    with torch.no_grad():
        np.testing.assert_allclose(m2.eval()(torch.tensor(x)).numpy(), want,
                                   atol=1e-4)


def test_committed_lifter_fixture_matches_skix():
    """ROADMAP's done criterion for the lifter: the committed checkpoint,
    held-out clips (seeds 1000-1002, never trained on): MPJPE < 50 mm, and
    the port's equal to skix's within 1e-5 m."""
    from make_lifter_fixture import H, W, synth_clip

    from skix_torch.geometry.camera import normalize_screen_coordinates as tnorm

    model = svp.TemporalLifter(filter_widths=(3, 3, 3), channels=128)
    variables = skix_load_checkpoint(str(FIXTURE))
    port = tvp.TemporalLifter(filter_widths=(3, 3, 3), channels=128)
    load_into(port, flax_to_state_dict(load_checkpoint(FIXTURE)))
    port.eval()
    infer = jit0(lambda v, k: svp.infer_sequence(model, v, k))
    errs_s, errs_t = [], []
    for seed in (1000, 1001, 1002):
        x3, px = synth_clip(seed=seed, T=120)
        pred_s = infer(variables, normalize_screen_coordinates(
            jnp.asarray(px), W, H))
        pred_t = tvp.infer_sequence(port, tnorm(torch.tensor(px), W, H))
        errs_s.append(float(jnp.mean(jnp.linalg.norm(pred_s - x3, axis=-1))))
        errs_t.append(float(torch.linalg.norm(
            pred_t - torch.tensor(x3), dim=-1).mean()))
    assert np.mean(errs_t) < 0.050, errs_t
    np.testing.assert_allclose(errs_t, errs_s, atol=1e-5)
