"""Weight bridge: a ``skix`` flax variables tree ↔ a PyTorch ``state_dict``.

The port's modules carry the flax names (``aggregator.frame_block_0.attn.qkv``,
``q_norm``, ``ls1.gamma``, ``camera_head.trunk_0`` …), so the bridge is a rule
per leaf, not a name table:

- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
- a DenseGeneral ``kernel`` becomes the 2-D ``weight`` of the port's
  ``Dense``: (C, H, hd) in-projections → (H·hd, C); the (H, hd, C) kernel of
  a module named ``out`` (the memory tracker's output projection) →
  (C, H·hd); its (H, hd) ``bias`` becomes (H·hd,);
- a Conv ``kernel`` HWIO becomes ``weight`` OIHW (a depthwise kernel
  (kh, kw, 1, C) so becomes torch's (C, 1, kh, kw)); a ConvTranspose
  kernel takes the same rule, and the port's ``ConvTranspose`` applies it
  flipped in space, as flax does not flip it;
- a 1-D Conv ``kernel`` (W, I, O) becomes ``weight`` (O, I, W): a 3-D
  kernel is a 1-D Conv unless its module is one of the DenseGenerals
  ``query``, ``key``, ``value``, ``out``;
- a BatchNorm's ``batch_stats`` ``mean`` and ``var`` become the
  ``running_mean`` and ``running_var`` buffers of the same module (its
  ``params`` ``scale``/``bias`` take the LayerNorm rule); a FrozenBatchNorm
  keeps its four ``params`` (``weight``, ``bias``, ``running_mean``,
  ``running_var``) under their names;
- a LayerNorm or GroupNorm ``scale`` becomes ``weight``; ``bias`` stays
  ``bias``;
- an Embed's ``embedding`` (vocab, width) becomes the ``weight`` of an
  ``nn.Embedding`` (the CLIP tower's ``token_embedding``), as it is;
- every other leaf (``camera_token``, ``register_token``,
  ``empty_pose_tokens``, ``gamma``, ``pos_embed``, ``query_pos``,
  ``init_boxes``, ``label_embed``, ``null_prompt``,
  ``positional_embedding``, ``text_projection``) is copied as it is.

The tree comes as nested dicts of arrays (``{"params": {...}}``, with
``"batch_stats"`` beside it where the model has BatchNorm, or the
``params`` subtree itself) or as the flat ``"params/a/b/kernel"`` npz that
``skix.pipelines.videopose3d.save_checkpoint`` writes. Reading an npz needs
numpy only, so a machine without JAX loads a skix checkpoint.

:func:`state_dict_to_flax` is the inverse bridge (a trained port module →
skix's ``params``): every rule above backwards, decided by the name and rank
of each torch leaf. A 2-D ``weight`` is a Dense kernel (transposed back),
except under a module whose name ends in ``embedding`` (an Embed's table);
a 4-D ``weight`` a Conv or ConvTranspose kernel (OIHW back to HWIO; the
port stores a ConvTranspose kernel unflipped and flips it where it applies
it, so no flip is undone here); a 3-D ``weight`` a 1-D Conv kernel; a 1-D
``weight`` a LayerNorm, GroupNorm or BatchNorm ``scale``; ``running_mean``
and ``running_var`` go to ``batch_stats`` as ``mean`` and ``var``
(``num_batches_tracked`` has no flax counterpart and is dropped); every
other leaf is copied. DenseGeneral's 3-D kernels and 2-D
biases take their shapes from a template of the flax tree.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch


def load_flat_npz(path: str | Path) -> dict[str, np.ndarray]:
    """The ``"params/a/b/kernel"`` arrays of a skix checkpoint npz."""
    with np.load(path, allow_pickle=False) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts → ``{"a/b/kernel": array}``."""
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


_DENSE_GENERAL = ("query", "key", "value", "out")
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _torch_leaf(name: str, arr: np.ndarray, module: str = ""
                ) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            if module == "out":
                return "weight", arr.reshape(-1, arr.shape[-1]).T
            if module in _DENSE_GENERAL:
                return "weight", arr.reshape(arr.shape[0], -1).T
            return "weight", arr.transpose(2, 1, 0)
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim} has no rule")
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "bias" and arr.ndim == 2:
        return name, arr.reshape(-1)
    return name, arr


def flax_to_state_dict(variables: Mapping[str, Any] | str | Path
                       ) -> dict[str, torch.Tensor]:
    """Convert a flax variables tree (nested dicts or a checkpoint npz path)
    into a float32 ``state_dict`` on the CPU."""
    if isinstance(variables, (str, Path)):
        flat = load_flat_npz(variables)
    else:
        flat = flatten_tree(variables)
    sd: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "batch_stats":
            parts = parts[1:-1] + [_BATCH_STATS[parts[-1]]]
            leaf, value = parts[-1], np.asarray(arr, np.float32)
        else:
            if parts[0] == "params":
                parts = parts[1:]
            leaf, value = _torch_leaf(parts[-1], np.asarray(arr, np.float32),
                                      parts[-2] if len(parts) > 1 else "")
        sd[".".join(parts[:-1] + [leaf])] = torch.tensor(value)
    return sd


def load_into(module: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]
              ) -> list[str]:
    """Copy ``state_dict`` into ``module`` (each tensor cast to its
    parameter's dtype and device). Every parameter of the module must be
    present (a BatchNorm's ``num_batches_tracked`` counter aside, which
    flax does not keep); keys the module does not have are returned, as
    flax ``apply`` ignores them (e.g. the DPT heads of a full VGGT
    checkpoint)."""
    missing, unexpected = module.load_state_dict(dict(state_dict),
                                                 strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters, "
                       f"e.g. {missing[:5]}")
    return list(unexpected)


def flax_leaf(name: str, arr: np.ndarray, module: str = ""
              ) -> tuple[str, np.ndarray]:
    """The flax leaf name and array of one torch leaf (inverse rules);
    ``module`` is the name of the leaf's module."""
    if name == "weight":
        if arr.ndim == 2 and module.endswith("embedding"):
            return "embedding", arr
        if arr.ndim == 2:
            return "kernel", arr.T
        if arr.ndim == 4:
            return "kernel", arr.transpose(2, 3, 1, 0)
        if arr.ndim == 3:
            return "kernel", arr.transpose(2, 1, 0)
        if arr.ndim == 1:
            return "scale", arr
        raise ValueError(f"weight of rank {arr.ndim} has no rule")
    return name, arr


def flax_path(key: str, shape) -> str:
    """The flax path (``"a/b/kernel"``, no ``params`` level) of the port's
    ``state_dict`` key ``key`` whose tensor has ``shape``: the name map of
    :func:`state_dict_to_flax`, for rules that match skix's paths (the
    ``sam3`` optimizer scheme's patterns)."""
    parts = key.split(".")
    leaf, _ = flax_leaf(parts[-1], np.broadcast_to(np.float32(0), tuple(shape)),
                        parts[-2] if len(parts) > 1 else "")
    return "/".join(parts[:-1] + [leaf])


def state_dict_to_flax(state_dict: Mapping[str, Any],
                       template: Mapping[str, Any] | None = None
                       ) -> dict[str, Any]:
    """Convert a port ``state_dict`` (or any mapping of its keys to tensors,
    such as the gradients of its parameters) into skix's variables tree
    ``{"params": {...}}`` (and ``"batch_stats"`` where it has BatchNorm
    statistics) of float32 numpy arrays: the inverse of
    :func:`flax_to_state_dict`. ``template`` (a flax tree, nested or flat
    ``"a/b/kernel"`` keys, with or without the ``params`` level) gives the
    shapes of DenseGeneral leaves; a leaf whose element count matches is
    reshaped to it. A leaf whose torch name the template holds as it is
    (FrozenBatchNorm's ``weight``, ``bias``, ``running_mean`` and
    ``running_var``, all ``params`` in skix) is copied under that name."""
    shapes = {}
    if template is not None:
        flat = flatten_tree(template)
        shapes = {k[len("params/"):] if k.startswith("params/") else k:
                  np.shape(v) for k, v in flat.items()}
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    stat_names = {v: k for k, v in _BATCH_STATS.items()}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        arr = (value.detach().to("cpu", torch.float32).numpy()
               if isinstance(value, torch.Tensor)
               else np.asarray(value, np.float32))
        if "/".join(parts) in shapes:       # a leaf the template names
            path = parts                      # as torch does (FrozenBN)
        elif parts[-1] in stat_names:
            node = stats
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[stat_names[parts[-1]]] = np.array(arr, np.float32)
            continue
        else:
            leaf, arr = flax_leaf(parts[-1], arr,
                                  parts[-2] if len(parts) > 1 else "")
            path = parts[:-1] + [leaf]
        want = shapes.get("/".join(path))
        if want is not None and tuple(want) != arr.shape:
            if int(np.prod(want)) != arr.size:
                raise ValueError(f"{key}: {arr.shape} does not fit the "
                                 f"template's {tuple(want)}")
            arr = arr.reshape(want)
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(arr, np.float32, order="C")  # a copy
    return {"params": params, **({"batch_stats": stats} if stats else {})}
