"""PyTorch + CUDA port of the Flash-LLM reproduction.

The JAX package ``repro`` is the reference; this package imports torch,
numpy and the standard library only, and is held against ``repro`` by
the ``tests/test_torch_*.py`` parity tests. Its Load-as-Sparse /
Compute-as-Dense SpMM kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
