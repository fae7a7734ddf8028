"""Helpers of the skix ↔ skix_torch parity tests (``tests/test_torch_*.py``)."""

import functools

import numpy as np

import jax


def random_variables(module, rng, *inputs, **init_kw):
    """Variables in the shapes ``module.init`` would give on ``inputs``
    (``eval_shape``: nothing is compiled; ``init_kw`` such as ``method`` go
    to ``init``), drawn from ``rng``: kernels with variance 1/fan_in,
    LayerNorm scales near 1, every other leaf (biases, tokens, LayerScale
    gammas) small but non-zero, so each parameter reaches the output."""
    shapes = jax.eval_shape(functools.partial(module.init, **init_kw),
                            jax.random.PRNGKey(0), *inputs)

    def draw(path, leaf):
        name = path[-1].key
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.05 * noise
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)

