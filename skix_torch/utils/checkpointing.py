"""Checkpoint helpers shared by the training loops, and the reference's
unix-pattern partial loading.

Port of ``skix/utils/checkpointing.py`` (the reference's epoch checkpoints
with optimizer state and resume, and ``train/utils/checkpoint_utils.py``'s
keep-list, include/exclude kernels and partial loading).

A "pytree" here is what skix's helpers take: nested dicts (lists and tuples
too) whose leaves are numpy arrays, torch tensors or scalars. A torch
module's weights become one through the weight bridge,
:func:`module_tree` (``convert.state_dict_to_flax``: ``params/...`` and
``batch_stats/...`` in flax's names), so that a pattern written for skix's
``/``-joined flax paths (``params/backbone/*``) selects the same parameters
in the port; :func:`load_tree_into` writes such a tree back into a module.

The one file that differs from skix's: skix writes each checkpoint with
orbax, as a directory ``<prefix>_XXXXXXXX``; the port writes
``<prefix>_XXXXXXXX.npz``, the flat ``/``-joined layout of
``pipelines.videopose3d.save_checkpoint`` (which ``train_lifter`` and
``train_detector`` write too), and reads it back into the structure of a
target tree. The ``<prefix>_XXXXXXXX.meta.json`` sidecar is skix's.
"""

from __future__ import annotations

import fnmatch
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np


def _npz_path(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(
        path.name + ".npz")


def _meta_path(path) -> Path:
    """``<prefix>_XXXXXXXX.meta.json`` beside ``<prefix>_XXXXXXXX.npz``."""
    path = Path(path)
    stem = path.name[:-4] if path.name.endswith(".npz") else path.name
    return path.with_name(stem + ".meta.json")


# --------------------------------------------------------------------------
# pytrees: jax's flattening order (dict keys sorted, None an empty subtree)
# --------------------------------------------------------------------------
def _flatten(tree: Any, prefix: str = "", keep_none: bool = False):
    """``[(name, leaf)]`` of ``tree`` in jax's ``tree_flatten`` order."""
    if tree is None:
        return [(prefix, None)] if keep_none else []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k, keep_none)
    return out


def _map_leaves(fn, tree: Any, prefix: str = ""):
    """``tree`` with every leaf ``x`` (None excluded) at ``name`` replaced by
    ``fn(name, x)``; containers keep their types."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(
            fn, v, f"{prefix}/{k}" if prefix else str(k)))
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}/{i}" if prefix
                                      else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _unflatten(pairs) -> dict:
    """``[(a/b/c, leaf)]`` → nested dicts."""
    tree: dict = {}
    for name, leaf in pairs:
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _to_numpy(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if hasattr(x, "detach")
            else np.asarray(x))


def module_tree(model) -> dict:
    """``model``'s parameters and buffers as skix's variables tree
    (``{"params": ..., "batch_stats": ...}`` of numpy arrays, flax names)."""
    from skix_torch.convert import state_dict_to_flax

    return state_dict_to_flax(model.state_dict())


def load_tree_into(model, tree: dict) -> list:
    """Copy a variables tree (flax names; ``None`` leaves are left out) into
    ``model`` in place; returns the keys the model does not have."""
    import torch

    from skix_torch.convert import flax_to_state_dict

    sd = flax_to_state_dict(_unflatten(
        (name, _to_numpy(leaf)) for name, leaf in _flatten(tree)))
    own = model.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k in own:
                own[k].copy_(v.to(own[k].dtype))
    return [k for k in sd if k not in own]


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------
def save_pytree(path: Path, tree: Any, metadata: Optional[dict] = None,
                keep_last: Optional[int] = None) -> None:
    """Save a pytree checkpoint (``<path>.npz``) + JSON metadata sidecar;
    prune old ones (each with its sidecar)."""
    path = _npz_path(Path(path).resolve())
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{name: _to_numpy(leaf)
                      for name, leaf in _flatten(tree)})
    if metadata is not None:
        _meta_path(path).write_text(json.dumps(metadata))
    if keep_last:
        prefix = path.name.split("_")[0]
        siblings = sorted(p for p in path.parent.iterdir()
                          if p.is_file() and p.suffix == ".npz"
                          and p.name.split("_")[0] == prefix)
        for old in siblings[:-keep_last]:
            old.unlink(missing_ok=True)
            _meta_path(old).unlink(missing_ok=True)


def restore_pytree(path: Path, target: Any = None) -> Any:
    """The checkpoint at ``path`` in the structure of ``target``: each leaf
    of the target is replaced by the stored array of its name, as a tensor
    of the target leaf's dtype and device where the leaf is a tensor, else
    as numpy. Without a target, the stored tree as nested dicts."""
    from skix_torch.convert import load_flat_npz

    flat = load_flat_npz(_npz_path(Path(path).resolve()))
    if target is None:
        return _unflatten(flat.items())

    def fill(name, leaf):
        if name not in flat:
            raise KeyError(f"checkpoint {path} lacks {name}")
        arr = flat[name]
        if hasattr(leaf, "detach"):
            import torch

            return torch.as_tensor(arr).to(dtype=leaf.dtype,
                                           device=leaf.device)
        return arr.astype(np.asarray(leaf).dtype)

    return _map_leaves(fill, target)


def latest_checkpoint_path(ckpt_dir: Path, prefix: str = "step"):
    """(path, metadata) of the newest ``<prefix>_*`` checkpoint or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    cands = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_file() and p.suffix == ".npz"
                   and p.name.startswith(f"{prefix}_"))
    if not cands:
        return None
    path = cands[-1]
    meta_file = _meta_path(path)
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    return path, meta


# ---------------------------------------------------------------------------
# Unix-pattern parameter selection + checkpoint kernels
# ---------------------------------------------------------------------------
# The reference's partial-loading machinery
# (train/utils/checkpoint_utils.py:27 unix_pattern_to_parameter_names,
# :44/:65 filter/exclude_params_matching_unix_pattern, :161
# CkptExcludeKernel, :244 load_checkpoint_and_apply_kernels) over pytrees:
# parameter "names" are '/'-joined paths (flax's, through module_tree).

def tree_param_names(tree: Any) -> list:
    """All leaf names of a pytree as ``a/b/c`` path strings."""
    return [name for name, _ in _flatten(tree)]


def unix_pattern_to_parameter_names(constraints, all_parameter_names):
    """Names matching ANY pattern; every pattern must match ≥1 name
    (checkpoint_utils.py:27-42 semantics incl. the assert)."""
    names = list(all_parameter_names)
    out = set()
    for pattern in constraints:
        matching = set(fnmatch.filter(names, pattern))
        if not matching:
            raise AssertionError(
                f"param_names {pattern} don't match any param in the given "
                f"names.")
        out |= matching
    return out


def _tree_filter_by_names(tree: Any, keep: set, invert: bool = False) -> Any:
    """Replace non-selected leaves with None (pruned subtrees stay in place
    so the result remains a valid partial pytree)."""
    return _map_leaves(lambda name, leaf: leaf if ((name in keep) != invert)
                       else None, tree)


def filter_params_matching_unix_pattern(patterns, tree: Any) -> Any:
    """Keep only leaves whose path matches one of ``patterns`` (others set
    to None). Empty pattern list → empty selection (reference :58)."""
    if not patterns:
        return _tree_filter_by_names(tree, set())
    keep = unix_pattern_to_parameter_names(patterns, tree_param_names(tree))
    return _tree_filter_by_names(tree, keep)


def exclude_params_matching_unix_pattern(patterns, tree: Any) -> Any:
    """Drop leaves whose path matches one of ``patterns`` (set to None).
    Empty pattern list → unchanged (reference :79)."""
    if not patterns:
        return tree
    drop = unix_pattern_to_parameter_names(patterns, tree_param_names(tree))
    return _tree_filter_by_names(tree, drop, invert=True)


class CkptIncludeKernel:
    """Keep only keys matching the patterns (applied at load time)."""

    def __init__(self, key_pattern):
        self.key_pattern = list(key_pattern)

    def __call__(self, state_dict: Any) -> Any:
        if not self.key_pattern:
            return state_dict
        return filter_params_matching_unix_pattern(self.key_pattern,
                                                   state_dict)


class CkptExcludeKernel:
    """Remove keys matching the patterns (checkpoint_utils.py:161)."""

    def __init__(self, key_pattern):
        self.key_pattern = list(key_pattern)

    def __call__(self, state_dict: Any) -> Any:
        if not self.key_pattern:
            return state_dict
        return exclude_params_matching_unix_pattern(self.key_pattern,
                                                    state_dict)


def load_checkpoint_and_apply_kernels(checkpoint_path: Path, target: Any,
                                      checkpoint_kernels=None) -> Any:
    """Restore a pytree checkpoint then apply processing kernels in order
    (checkpoint_utils.py:244). Returns the (possibly pruned) pytree; use
    ``merge_params`` to overlay it onto a fresh init."""
    tree = restore_pytree(Path(checkpoint_path), target)
    for kernel in (checkpoint_kernels or []):
        tree = kernel(tree)
    return tree


def merge_params(base: Any, overlay: Any) -> Any:
    """Overlay non-None leaves of ``overlay`` onto ``base`` by path (the
    analog of load_state_dict(strict=False) after include/exclude
    kernels). Overlay paths absent from ``base`` are ignored."""
    omap = dict(_flatten(overlay, keep_none=True))
    return _map_leaves(lambda name, leaf: leaf if omap.get(name) is None
                       else omap[name], base)
