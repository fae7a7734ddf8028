"""skix_torch's KL-VAE and LoRA fusion against skix's, on the CPU.

The VAE (vae_ch 8, three down stages, 16 latent channels, a 32 × 32
image) carries weights drawn from a seeded numpy generator
(``_torch_parity.port_variables``) that skix gets through the inverse
bridge; encode (mean and clipped log-variance) and decode are held to 1e-4
of the largest element where that exceeds 1. skix's programs are compiled
once (``jit0``). LoRA: both key layouts convert to skix's arrays exactly,
and fusing into the MMDiT (the ``lora_scale`` 1.25 of the config, a
transposed entry; a norm entry and a path that names nothing, both
skipped) gives skix's fused weights exactly; a conv entry is skipped by
both.
"""

import warnings

import numpy as np
import pytest
import torch

from _torch_parity import close_scaled, jit0, port_variables

from skix.models import lora as SL
from skix.models import vae as SV
from skix_torch.convert import flax_to_state_dict
from skix_torch.models import lora as PL
from skix_torch.models import mmdit as PM
from skix_torch.models import vae as PV

rng = np.random.default_rng(2424)
CH, LAT = 8, 16
VAE = PV.KLVAE(ch=CH, latent_channels=LAT).eval()
VARS = port_variables(VAE, 11)
SVAE = SV.KLVAE(ch=CH, latent_channels=LAT)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_vae_encode_decode():
    img = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        mean, logvar = VAE.encode(_t(img))
    w_mean, w_logvar = jit0(lambda v, x: SVAE.apply(
        v, x, method=SVAE.encode))(VARS, img)
    close_scaled(mean.numpy(), w_mean, 1e-4)
    close_scaled(logvar.numpy(), w_logvar, 1e-4)
    z = rng.normal(size=(2, 4, 4, LAT)).astype(np.float32)
    with torch.no_grad():
        got = VAE.decode(_t(z))
    want = jit0(lambda v, x: SVAE.apply(v, x, method=SVAE.decode))(VARS, z)
    assert got.shape == (2, 32, 32, 3)
    close_scaled(got.numpy(), want, 1e-4)


def test_converter_both_layouts():
    state = {
        "blk.attn.q.lora_A.weight": rng.normal(size=(2, 8)),
        "blk.attn.q.lora_B.weight": rng.normal(size=(4, 2)),
        "blk.mlp.fc.lora.down.weight": rng.normal(size=(3, 6)),
        "blk.mlp.fc.lora.up.weight": rng.normal(size=(5, 3)),
        "blk.mlp.fc.alpha": np.asarray(6.0),
        "blk.proj.lora_down.weight": torch.ones(2, 3),
        "blk.proj.lora_up.weight": torch.ones(3, 2),
        "blk.lonely.lora_A.weight": np.ones((2, 2)),
    }
    got, want = PL.convert_safetensors_lora(state), \
        SL.convert_safetensors_lora(state)
    assert sorted(got) == sorted(want) == ["blk.attn.q", "blk.mlp.fc",
                                           "blk.proj"]
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)


def test_fusion_matches_skix():
    kw = dict(in_channels=12, out_channels=3, num_layers=1,
              attention_head_dim=32, num_attention_heads=2,
              joint_attention_dim=16, axes_dims_rope=(8, 12, 12))
    dit = PM.QwenImageDiT(**kw)
    variables = port_variables(dit, 12)
    r = 4
    lora = {
        "blocks_0.to_q": (rng.normal(size=(r, 64)).astype(np.float32),
                          rng.normal(size=(64, r)).astype(np.float32), 8.0),
        # stored the other way round: fused transposed
        "img_in": (rng.normal(size=(r, 64)).astype(np.float32),
                   rng.normal(size=(12, r)).astype(np.float32), float(r)),
        "blocks_0.txt_mlp_out": (
            rng.normal(size=(r, 256)).astype(np.float32),
            rng.normal(size=(64, r)).astype(np.float32), 2.0),
        "blocks_0.norm_q": (np.ones((r, 32), np.float32),
                            np.ones((32, r), np.float32), 1.0),
        "nothing.here": (np.ones((r, 4), np.float32),
                         np.ones((4, r), np.float32), 1.0),
    }
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        n = PL.apply_lora(dit, lora, scale=1.25)
        fused, n_skix = SL.apply_lora(variables, lora, scale=1.25)
    assert n == n_skix == 3
    assert sum("2 LoRA entries" in str(w.message) for w in caught) == 2
    want = flax_to_state_dict(fused)
    got = dit.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    assert not np.array_equal(got["img_in.weight"].numpy(),
                              flax_to_state_dict(variables)[
                                  "img_in.weight"].numpy())


def test_conv_entries_are_skipped():
    vae = PV.KLVAE(ch=CH, latent_channels=LAT)
    before = {k: v.clone() for k, v in vae.state_dict().items()}
    lora = {"encoder.stem": (np.ones((2, 27), np.float32),
                             np.ones((8, 2), np.float32), 2.0)}
    with pytest.warns(UserWarning, match="skipped"):
        assert PL.apply_lora(vae, lora) == 0
    for k, v in vae.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.warns(UserWarning, match="skipped"):
        assert SL.apply_lora(VARS, lora)[1] == 0
