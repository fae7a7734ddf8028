"""LoRA adapters: read safetensors-shaped dicts, fuse them into a module.

Port of ``skix/models/lora.py``. Fusion is

    W' = W + scale · (alpha / r) · (up @ down)

on every Dense whose module path matches a LoRA entry (``"."``-separated
names, which are skix's flax paths and the port's module paths alike);
convolutions, embeddings and norms are skipped with a warning, as skix
skips every leaf that is not a 2-D Dense kernel. The delta is computed in
numpy float32 exactly as skix computes it, so the fused weights are the
ones skix fuses. :func:`convert_safetensors_lora` accepts both key layouts
(``*.lora_A.weight``/``*.lora_B.weight`` and ``*.lora.down.weight``/
``*.lora.up.weight`` or ``*.lora_down``/``*.lora_up``, with optional
``*.alpha``).
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

_SUFFIXES = ((".lora_A.weight", "down"), (".lora_B.weight", "up"),
             (".lora.down.weight", "down"), (".lora.up.weight", "up"),
             (".lora_down.weight", "down"), (".lora_up.weight", "up"))


def convert_safetensors_lora(state: Dict) -> Dict[str, Tuple]:
    """safetensors-shaped dict → ``{module_path: (down (r, in), up (out, r),
    alpha)}`` in the torch orientation; alpha defaults to r."""
    def np_of(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v)

    parts: Dict[str, Dict[str, np.ndarray]] = {"down": {}, "up": {}}
    alphas = {}
    for key, val in state.items():
        for suffix, role in _SUFFIXES:
            if key.endswith(suffix):
                parts[role][key[: -len(suffix)]] = np_of(val)
                break
        else:
            if key.endswith(".alpha"):
                alphas[key[: -len(".alpha")]] = float(np_of(val))
    out = {}
    for base, down in parts["down"].items():
        if base in parts["up"]:
            out[base] = (down, parts["up"][base],
                         alphas.get(base, float(down.shape[0])))
    return out


def apply_lora(module: nn.Module, lora: Dict[str, Tuple],
               scale: float = 1.0) -> int:
    """Fuse ``lora`` into ``module``'s Dense weights in place; returns the
    number fused. An entry whose path names no Dense, or whose delta fits
    the weight neither way round, is skipped with one warning."""
    fused, skipped = 0, []
    for path, (down, up, alpha) in lora.items():
        try:
            target = module.get_submodule(path)
        except AttributeError:
            target = None
        if not isinstance(target, nn.Linear):
            skipped.append(path)
            continue
        weight = target.weight.detach().cpu().numpy()        # (out, in)
        r = down.shape[0]
        delta = (up @ down) * (scale * alpha / r)             # (out, in)
        if delta.shape != weight.shape:
            if delta.T.shape != weight.shape:
                skipped.append(path)
                continue
            delta = delta.T
        with torch.no_grad():
            target.weight.copy_(torch.as_tensor(
                weight + delta.astype(weight.dtype)))
        fused += 1
    if skipped:
        warnings.warn(f"apply_lora: {len(skipped)} LoRA entries did not "
                      f"match any 2-D Dense kernel and were skipped "
                      f"(first: {skipped[0]!r})", stacklevel=2)
    return fused
