"""skix_torch.ops.window_probe's plain versions against the TPU probe
kernels they stand for (scripts/bench_window_decomp.py's ``make_kernel``,
run through the Pallas interpreter on the CPU), on the same seeded inputs.

The CUDA variants themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s window_probe
phase).
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from skix.ops.attention import _rot_matrix
from skix_torch.ops import attention as A
from skix_torch.ops import window_probe as W

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import bench_window_decomp as B1  # noqa: E402

B, H, S, D = 1, 2, 128, 64


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    q, k, v = (r.normal(size=(B, H, S, D)).astype(np.float32)
               for _ in range(3))
    ang = r.uniform(0, 6.3, size=(S, D // 2)).astype(np.float32)
    cos, sin = (np.repeat(f(ang), 2, axis=-1) for f in (np.cos, np.sin))
    return q, k, v, cos, sin


def _tpu_probe(variant, q, k, v, cos, sin):
    """The TPU script's kernel for ``variant``, all heads in one grid cell
    (G = H), interleaved rope, interpreted."""
    with_rope = variant != "norope"
    kernel = B1.make_kernel(variant, 1.0 / math.sqrt(D), H, with_rope)
    spec = pl.BlockSpec((1, H, S, D), lambda b, h: (b, h, 0, 0))
    operands = [jnp.asarray(x) for x in (q, k, v)]
    in_specs = [spec] * 3
    if with_rope:
        operands += [jnp.asarray(cos), jnp.asarray(sin),
                     jnp.asarray(_rot_matrix(D, "interleaved"))]
        in_specs += [pl.BlockSpec((S, D), lambda b, h: (0, 0))] * 2 \
            + [pl.BlockSpec((D, D), lambda b, h: (0, 0))]
    (out,) = pl.pallas_call(
        kernel, grid=(B, 1), in_specs=in_specs, out_specs=[spec],
        out_shape=[jax.ShapeDtypeStruct(q.shape, jnp.float32)],
        interpret=True)(*operands)
    return np.asarray(out)


@pytest.mark.parametrize("variant", ["full", "norope", "fixedmax",
                                     "nosoftmax", "scoresonly"])
def test_plain_variant_matches_tpu_probe(inputs, variant):
    """Each B1 variant's plain version computes what the TPU probe kernel
    computed (f32: the sum order alone, scaled by the output's size for the
    unnormalised ones)."""
    q, k, v, cos, sin = inputs
    want = _tpu_probe(variant, q, k, v, cos, sin)
    got = W.plain(variant, *(torch.from_numpy(x) for x in (q, k, v)),
                  torch.from_numpy(cos), torch.from_numpy(sin),
                  "interleaved", 1.0 / math.sqrt(D)).numpy()
    if variant == "scoresonly":
        want = want[..., :D]
    tol = W.tolerance(variant, "float32") * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_p_bf16_rounds_only_p_and_v():
    """p_bf16 is softmax attention with p and v rounded to bf16 before P·V
    and the row sums of the unrounded p."""
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.normal(size=(1, 1, 64, 64))
                                .astype(np.float32)) for _ in range(3))
    got = W.plain("p_bf16", q, k, v, None, None, "half", 0.125)
    s = (q * float(np.float32(0.125 * W._LOG2E))) @ k.transpose(-1, -2)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v.bfloat16().float()) / p.sum(-1, True)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    full = A.attention_reference(q, k, v, 0.125)
    assert (got - full).abs().max() > 1e-5


def test_bounds_and_variants_table():
    """Every B row names its TPU script and runs only variants the C entry
    has; the bound counts three tf32 products per f32 product."""
    for row, (script, kline, call, _) in W.PROBES.items():
        assert (Path(__file__).resolve().parents[1] / script).exists()
        assert kline < call
    for runs in W.RUNS.values():
        for variant, dtype, _ in runs:
            assert variant in W.VARIANTS
            assert not (variant == "kv_other_major" and dtype == "float32")
            assert not (variant == "p_bf16" and dtype == "bfloat16")
    ms, by = W.bound_ms("full", "float32", W.SHAPE, True)
    ops = 4.0 * math.prod(W.SHAPE) * W.SHAPE[2]
    assert by == "operations"
    assert ms == pytest.approx(3 * ops / 495e12 * 1e3)
