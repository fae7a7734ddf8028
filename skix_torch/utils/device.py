"""Device selection for the port's entry points, the card's numerics where
they need care (cuDNN's TF32, cuSOLVER's batch limit), and constant arrays
kept on the device."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name: str | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. There is no silent CPU path: asking for CUDA on a machine
    without it raises."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def full_float32_convs():
    """A context in which cuDNN's float32 convolutions run in float32
    (PyTorch lets them use TF32 by default, ~1e-3 relative); cuDNN's other
    flags stay as they are, and so does the global setting outside it."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def by_chunks(fn, M: torch.Tensor, chunk: int = 16384):
    """``fn`` (a batched factorization returning a tuple, such as
    ``torch.linalg.eigh``) over ``M (..., n, n)`` in slices of at most
    ``chunk`` matrices: cuSOLVER's batched eigensolver refuses a batch of
    900 frames × 256 hypotheses (CUSOLVER_STATUS_INVALID_VALUE)."""
    flat = M.reshape(-1, *M.shape[-2:])
    parts = [fn(flat[i:i + chunk]) for i in range(0, max(len(flat), 1), chunk)]
    return tuple(torch.cat(outs).reshape(*M.shape[:-2], *outs[0].shape[1:])
                 for outs in zip(*parts))


_CONSTANTS: dict = {}


def constant(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """The numpy array ``a``, a module-level constant (index tables, signs),
    as a tensor on ``device``, copied there once per array, device and
    dtype (the cache holds ``a``: pass no temporaries). A copy from pageable
    host memory is synchronous: a model that made its index tensors on
    every call would drain the card's queue at each one."""
    key = (id(a), str(device), dtype)
    hit = _CONSTANTS.get(key)
    if hit is None or hit[0] is not a:
        hit = _CONSTANTS[key] = (a, torch.as_tensor(a, device=device,
                                                    dtype=dtype))
    return hit[1]
