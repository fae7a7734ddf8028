"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``skix_torch/ops/csrc/<name>.cu`` has a plain C interface and compiles
with ``nvcc`` alone (no PyTorch headers, no ninja) into
``skix_torch/_build/lib<name>-<hash>.so``, where the hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags: an edited source
builds anew, an unchanged one is reused. ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library as ``<name>-<hash>.log``. A failed
build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of skix_torch are built at first use")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    stem = f"{name}-{digest.hexdigest()[:12]}"
    return BUILD_DIR / f"lib{stem}.so", BUILD_DIR / f"{stem}.log"


def build(names) -> dict[str, Path]:
    """Compile every named source that has no library yet, all ``nvcc``
    processes started together; returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, running = {}, []
    for name in names:
        lib, log = _target(name)
        libs[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, lib, log))
    errors = []
    for name, proc, tmp, lib, log in running:
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    _, log = _target(name)
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return _LOADED[name]
