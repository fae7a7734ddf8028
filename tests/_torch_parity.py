"""Helpers of the skix ↔ skix_torch parity tests (``tests/test_torch_*.py``)."""

import functools

import numpy as np
import torch

import jax

# One compute thread a test process. Tier-1 runs 6 pytest-xdist workers on
# the machine's cores; torch's OpenMP pool and numpy's OpenBLAS pool (one
# thread a core each, in every worker) oversubscribe them about 6×, and
# the spinning threads slow every worker, JAX's compiles included. Every
# worker imports this module when it collects the port's test files,
# before any test runs.
torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits

    threadpool_limits(1)
except ImportError:       # numpy's pool keeps its size
    pass


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



def _close(a, b, atol, where, scaled=False):
    """``a`` and ``b`` (JSON values, CSV cells, arrays) agree: numbers within
    ``atol`` (NaN equal to NaN, as a missing value), everything else equal.
    ``scaled``: ``atol`` is relative to each array's largest element where
    that exceeds 1."""
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], atol, f"{where}/{k}", scaled)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, atol, f"{where}[{i}]", scaled)
    elif isinstance(a, np.ndarray) and a.dtype.kind not in "fc":
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (float, int, np.ndarray)) and not isinstance(a, bool):
        a = np.asarray(a, np.float64)
        if scaled and a.size and np.isfinite(a).any():
            atol = atol * max(1.0, float(np.nanmax(np.abs(a))))
        np.testing.assert_allclose(a, np.asarray(b, np.float64), atol=atol,
                                   rtol=0, equal_nan=True, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _cell(s):
    try:
        return float(s) if s != "" else float("nan")
    except ValueError:
        return s


def assert_same_outputs(want_dir, got_dir, atol=1e-4, limits=None,
                        ignore=(), scaled=False):
    """Every file skix wrote under ``want_dir`` exists under ``got_dir`` (and
    no other), with the same content: arrays (``.npy``, each array of an
    ``.npz``), JSON documents (the same keys) and CSV tables agree within
    ``atol``, or ``limits[<file name>]`` (with ``scaled``, relative to each
    array's largest element where that exceeds 1); a file whose name is in
    ``ignore`` (timings, videos) only has to exist."""
    import csv
    import json
    from pathlib import Path

    limits = limits or {}
    want_dir, got_dir = Path(want_dir), Path(got_dir)
    want = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*")
                 if p.is_file())
    assert [str(p) for p in got] == [str(p) for p in want]
    for rel in want:
        a, b = want_dir / rel, got_dir / rel
        tol = limits.get(rel.name, atol)
        if rel.name in ignore or rel.suffix in (".mp4", ".png"):
            continue
        if rel.suffix == ".npy":
            _close(np.load(a), np.load(b), tol, str(rel), scaled)
        elif rel.suffix == ".npz":
            with np.load(a) as za, np.load(b) as zb:
                _close({k: za[k] for k in za.files},
                       {k: zb[k] for k in zb.files}, tol, str(rel), scaled)
        elif rel.suffix == ".json":
            _close(json.loads(a.read_text()), json.loads(b.read_text()), tol,
                   str(rel))
        elif rel.suffix == ".csv":
            rows = [[[_cell(c) for c in r] for r in csv.reader(open(p))]
                    for p in (a, b)]
            _close(rows[0], rows[1], tol, str(rel))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def run_stage_twins(tmp_path, name, body, skix_main, port_main):
    """A stage's YAML config (``body`` with ``{out}`` for ``out_root``) run
    by skix into ``skix/`` and by the port (``device: cpu``) into
    ``port/``; returns the two output roots."""
    outs = {}
    for side, fn in (("skix", skix_main), ("port", port_main)):
        out = tmp_path / side
        cdir = tmp_path / f"cfg_{side}" / "configs"
        cdir.mkdir(parents=True, exist_ok=True)
        (cdir / f"{name}.yaml").write_text(body.format(out=out)
                                           + "device: cpu\n")
        fn([f"--config-dir={cdir}"])
        outs[side] = out
    return outs["skix"], outs["port"]


def close_scaled(got, want, tol):
    """``got`` within ``tol`` of ``want``, relative to ``want``'s largest
    element where that exceeds 1 (pixels, cm-scale rig sums)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * scale)


def sam3d_body_pair(rng, **kw):
    """skix's ``SAM3DBody(**kw)``, random variables for every parameter the
    estimator reaches (the body tree with the prompt encoder, and the hand
    branch; a DINOv3 trunk keeps its formula's rope periods), the port's
    model carrying them, and skix's jitted apply: ``(skix_model,
    variables, port_model, apply)``."""
    import jax.numpy as jnp

    from skix.models.sam3d_body import SAM3DBody
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models import sam3d_body as P

    smod = SAM3DBody(**kw)
    crops = jnp.zeros((1, smod.crop_size, smod.crop_size, 3))
    v = random_variables(smod, rng, crops, jnp.zeros((1, 3, 3)),
                         jnp.ones((1, 3), bool))
    params = dict(v["params"])
    # the hand branch: its init tokens and head, shaped as the body's
    params["hand_init_tokens"] = 0.05 * rng.normal(
        size=params["init_tokens"].shape).astype(np.float32)
    params["head_hand"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) / np.sqrt(a.shape[0]) if a.ndim
                   == 2 else 0.05 * rng.normal(size=a.shape)).astype(
                       np.float32), params["head_pose"])
    if smod.backbone.startswith("dinov3"):
        from skix.models.dinov3 import dinov3_rope_periods

        trunk = params["dino_backbone"]
        params["dino_backbone"] = dict(trunk, rope_periods=dinov3_rope_periods(
            4 * trunk["rope_periods"].shape[0]))
    variables = {"params": params}
    model = P.SAM3DBody(**kw)
    assert not load_into(model, flax_to_state_dict(variables))
    return (smod, variables, model.eval(),
            jit0(smod.apply, static_argnames=("decoder_type",)))


def assert_sam3d_outputs_close(got, want, tol=1e-4):
    """Every field of two ``SAM3DBodyOutputs`` (the MHR head's too) agrees
    within ``tol`` (:func:`close_scaled`)."""
    for name in want.mhr._fields:
        close_scaled(getattr(got.mhr, name), getattr(want.mhr, name), tol)
    for name in ("cam_t", "joints_3d", "joints_2d_crop", "vertices_3d"):
        close_scaled(getattr(got, name), getattr(want, name), tol)


def port_variables(module, seed: int):
    """Draw every parameter and buffer of the port's ``module`` from a numpy
    generator seeded ``seed`` (kernels with variance 1/fan_in, 1-D weights
    near 1, running variances in [0.5, 1.5], everything else small but
    non-zero), load them, and return the same values as skix's variables
    (``convert.state_dict_to_flax``): no flax ``init`` is traced, so a file
    compiles each skix model once, for its apply."""
    import torch

    from skix_torch.convert import state_dict_to_flax

    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = t
            continue
        noise = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            arr = rng.uniform(0.5, 1.5, size=tuple(t.shape))
        elif leaf == "weight" and t.dim() >= 2:
            arr = noise / np.sqrt(np.prod(t.shape[1:]))
        elif leaf == "weight":
            arr = 1.0 + 0.05 * noise
        else:
            arr = 0.05 * noise
        sd[name] = torch.as_tensor(np.asarray(arr, np.float32))
    module.load_state_dict(sd)
    # statistics held as parameters (FrozenBatchNorm) stay parameters
    stats = {k.rsplit(".", 1)[0] for k, _ in module.named_parameters()
             if k.endswith("running_mean")}
    frozen = {k.replace(".", "/"): np.zeros(tuple(p.shape))
              for k, p in module.named_parameters()
              if k.rsplit(".", 1)[0] in stats}
    return state_dict_to_flax(module.state_dict(), frozen or None)


# XLA's backend at optimization level 0: a parity file runs each skix
# program on one or two tiny inputs, where the optimizing passes cost more
# than they save (the tiny Sam3Detector's forward: 3.0 → 1.2 s to compile,
# the same time to run)
_CHEAP = {"xla_backend_optimization_level": "0",
          "xla_llvm_disable_expensive_passes": True}


def compile_once(fn, *args):
    """``jax.jit(fn)`` lowered and compiled for ``args`` (``_CHEAP``)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_CHEAP)


def jit0(fn, static_argnames=()):
    """``jax.jit(fn, static_argnames=...)`` for the parity tests: each
    argument signature (and value of the static keywords) lowered and
    compiled once (``_CHEAP``)."""
    jitted, compiled = jax.jit(fn, static_argnames=static_argnames), {}

    def call(*args, **kwargs):
        static = tuple(sorted((k, kwargs.pop(k)) for k in static_argnames
                              if k in kwargs))
        leaves, tree = jax.tree_util.tree_flatten((args, kwargs))
        key = (tree, static,
               tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args, **kwargs, **dict(
                static)).compile(compiler_options=_CHEAP)
        return compiled[key](*args, **kwargs)
    return call


def graft_geometry(det_vars, d_model: int = 64, max_points: int = 8,
                   max_boxes: int = 4, seed: int = 0):
    """skix's Sam3Detector ``det_vars`` (nested, ``{"params": ...}``) with a
    ``geometry_encoder`` branch drawn by skix's ``GeometryPromptEncoder``
    init (``PRNGKey(seed)``) where it has none: the branch skix's
    ``Sam3Processor`` and ``VideoPredictor`` graft onto a tree without it.
    Both packages are then given the same tree."""
    import jax.numpy as jnp

    from skix.tracking.sam3_detector import GeometryPromptEncoder

    params = dict(det_vars["params"])
    if "geometry_encoder" not in params:
        enc = GeometryPromptEncoder(d_model, max_points, max_boxes)
        z = jnp.zeros
        params["geometry_encoder"] = jax.jit(
            enc.init, compiler_options=_CHEAP)(
            jax.random.PRNGKey(seed), z((1, 2, 2, d_model)),
            z((1, max_points, 2)), z((1, max_points), jnp.int32),
            z((1, max_points), bool), z((1, max_boxes, 4)),
            z((1, max_boxes), jnp.int32), z((1, max_boxes), bool))["params"]
    return {**det_vars, "params": params}


def cheap_jit(jitted, static_argnums=()):
    """A skix function decorated with ``jax.jit`` (static
    ``static_argnums``), compiled once per signature at XLA's level 0
    (``_CHEAP``) where it is called at top level; inside another jitted
    program (its arguments are tracers) its plain body is traced into
    that program, since only a top-level jit takes compiler options."""
    raw = jitted.__wrapped__
    cheap = jax.jit(raw, static_argnums=static_argnums,
                    compiler_options=_CHEAP)

    def call(*args, **kwargs):
        if any(isinstance(x, jax.core.Tracer)
               for x in jax.tree_util.tree_leaves((args, kwargs))):
            return raw(*args, **kwargs)
        return cheap(*args, **kwargs)
    return call
