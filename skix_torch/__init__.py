"""skix_torch — the PyTorch / CUDA port of ``skix`` for one NVIDIA H100.

It sits beside the JAX package, which stays the reference: every module
here is held against its ``skix`` counterpart on the same inputs and the
same weights in the CPU tests (``tests/test_torch_*.py``). It imports
``torch`` and never JAX or ``skix``.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``.
On a CUDA tensor the attention wrapper launches the hand-written Hopper
kernel (``skix_torch/ops/csrc/flash_fwd.cu``) or raises; on a CPU tensor
it runs the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
