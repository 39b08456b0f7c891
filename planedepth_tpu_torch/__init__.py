"""PlaneDepth in PyTorch and CUDA: the port of ``planedepth_tpu`` to one NVIDIA H100.

The JAX package stays the reference; every module here is held against its
JAX counterpart by ``tests/test_torch_*.py``.  Tensors are NCHW with the plane
axis at dim 1, ``(B, N, H, W)``.  The package imports ``torch``, ``numpy`` and
the standard library only.  Kernels are hand-written CUDA under ``csrc/``,
built with ``nvcc`` at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
