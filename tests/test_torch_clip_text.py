"""skix_torch's CLIP tokenizer and VE text encoder against skix's.

- token ids equal skix's ``ClipTokenizer`` for ASCII, punctuation,
  non-ASCII and over-long prompts (both read the same merge table, each
  package its own copy);
- ``VETextEncoder`` (d_model 32, width 48, 4 heads, 2 layers, context 16,
  vocab 128) from one set of flax variables through the weight bridge, and
  from a synthetic reference state dict through each package's converter:
  the valid mask exactly, the resized memory and the input embeddings at
  1e-4 (float32 sums in other orders);
- skix's stage tokenizes with CLIP's default context (77), which its
  32-token encoder cannot take; the port's stage uses the encoder's
  context.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import jit0, random_variables

from skix_torch.convert import (flax_to_state_dict, flatten_tree, load_into,
                                state_dict_to_flax)

TINY = dict(d_model=32, width=48, heads=4, layers=2, context_length=16,
            vocab_size=128)
PROMPTS = {
    "ascii": ["person", "snow", "a skier on the slope"],
    "punctuation": ["skier, jumping! (left)", "it's the 2nd run: go?"],
    "non_ascii": ["naïve café", "Skifahrer über Schnee", "滑雪者", "😀 snow"],
    "long": ["one two three four five six seven eight nine ten " * 5],
}


@pytest.mark.parametrize("kind", list(PROMPTS))
def test_token_ids_match_skix(kind):
    from skix.tracking.clip_tokenizer import ClipTokenizer as SkixTokenizer
    from skix_torch.tracking.clip_tokenizer import ClipTokenizer

    for ctx in (77, 32):
        want = SkixTokenizer(context_length=ctx)(PROMPTS[kind])
        got = ClipTokenizer(context_length=ctx)(PROMPTS[kind])
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    if kind == "long":       # truncated to 32, EOT in the last slot
        assert got[0, -1] == ClipTokenizer().eot_token_id


def _tokens(seed):
    t = np.random.default_rng(seed).integers(1, 128, (3, 16)).astype(np.int32)
    t[0, 5:], t[1, 12:] = 0, 0          # padded prompts
    return t


def _compare(got, want):
    valid, resized, embeds = got
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[0]))
    for g, w in zip((resized, embeds), want[1:]):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_ve_text_encoder_matches_skix():
    from skix.tracking.clip_text import VETextEncoder as SkixVE
    from skix_torch.tracking.clip_text import VETextEncoder

    tok = _tokens(0)
    m = SkixVE(**TINY)
    v = random_variables(m, np.random.default_rng(1), jnp.asarray(tok))
    want = jit0(m.apply)(v, jnp.asarray(tok))
    port = VETextEncoder(**TINY)
    assert load_into(port, flax_to_state_dict(v)) == []
    with torch.no_grad():
        _compare(port(torch.as_tensor(tok)), want)
    # the inverse bridge gives skix's tree back (Embed included)
    back = flatten_tree(state_dict_to_flax(port.state_dict(), v))
    for k, w in flatten_tree(v).items():
        np.testing.assert_array_equal(back[k], np.asarray(w, np.float32),
                                      err_msg=k)


def _reference_ve_sd(r, d_model=32, width=48, layers=2, ctx=16, vocab=128):
    n = lambda *s: (r.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    sd = {"encoder.token_embedding.weight": n(vocab, width),
          "encoder.positional_embedding": n(ctx, width),
          "encoder.ln_final.weight": 1 + n(width),
          "encoder.ln_final.bias": n(width),
          "encoder.text_projection": n(width, d_model),
          "resizer.weight": n(d_model, width), "resizer.bias": n(d_model)}
    for i in range(layers):
        pre = f"encoder.transformer.resblocks.{i}."
        sd.update({pre + "ln_1.weight": 1 + n(width), pre + "ln_1.bias": n(width),
                   pre + "ln_2.weight": 1 + n(width), pre + "ln_2.bias": n(width),
                   pre + "attn.in_proj_weight": n(3 * width, width),
                   pre + "attn.in_proj_bias": n(3 * width),
                   pre + "attn.out_proj.weight": n(width, width),
                   pre + "attn.out_proj.bias": n(width),
                   pre + "mlp.c_fc.weight": n(4 * width, width),
                   pre + "mlp.c_fc.bias": n(4 * width),
                   pre + "mlp.c_proj.weight": n(width, 4 * width),
                   pre + "mlp.c_proj.bias": n(width)})
    return sd


def test_convert_ve_text_encoder_matches_skix():
    """A synthetic state dict in the reference's layout (with a text
    projection, which VETextEncoder does not use) through skix's converter
    and skix's forward, against the port's converter and forward."""
    from skix.tracking.clip_text import VETextEncoder as SkixVE
    from skix.tracking.clip_text import \
        convert_ve_text_encoder as skix_convert
    from skix_torch.tracking.clip_text import (VETextEncoder,
                                               convert_ve_text_encoder)

    sd = _reference_ve_sd(np.random.default_rng(2))
    tok = _tokens(3)
    want = jit0(SkixVE(**TINY).apply)(skix_convert(sd), jnp.asarray(tok))
    port = VETextEncoder(**TINY)
    assert load_into(port, convert_ve_text_encoder(sd)) == [
        "encoder.text_projection"]
    with torch.no_grad():
        _compare(port(torch.as_tensor(tok)), want)


def test_stage_tokenizer_takes_the_encoders_context():
    """skix's prepare_front_results builds ``ClipTokenizer()`` (context 77)
    for its ``VETextEncoder`` (context 32), whose positional table cannot
    take 77 tokens: skix's stage cannot run a CLIP checkpoint. The port's
    stage builds the tokenizer with the encoder's context."""
    from skix.tracking.clip_text import VETextEncoder as SkixVE
    from skix.tracking.clip_tokenizer import ClipTokenizer as SkixTokenizer
    from skix_torch.tracking.clip_tokenizer import ClipTokenizer

    kw = dict(TINY, vocab_size=49408)
    m = SkixVE(**kw)
    v = jit0(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    apply = jit0(m.apply)
    with pytest.raises((TypeError, ValueError), match="broadcast|shapes"):
        apply(v, jnp.asarray(SkixTokenizer()(["person"])))
    tok = ClipTokenizer(context_length=kw["context_length"])(["person"])
    assert tok.shape == (1, 16)
    valid, _, _ = apply(v, jnp.asarray(tok))
    assert int(np.asarray(valid).sum()) == 3      # SOT, person, EOT
